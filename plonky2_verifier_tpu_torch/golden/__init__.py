"""Golden model: bit-exact, slow, pure-Python executable specification.

This subpackage is the oracle for every TPU kernel and the debugger for
transcript divergences. Nothing here is performance-relevant.
"""
