"""Circuit-template compiler (template.py, flatten.py: the host tier), the
gate-program levelizer (numpy) and its PyTorch executor."""

from .template import CircuitTemplate  # noqa: F401
from .flatten import flatten_proofs  # noqa: F401
