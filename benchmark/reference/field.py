"""The Goldilocks field, its quadratic extension and the extension algebra
over that extension, as plonky2_field defines them:

- `goldilocks_field.rs`: p = 2^64 - 2^32 + 1, MULTIPLICATIVE_GROUP_GENERATOR
  14293326489335486720 (the coset shift of the LDE, and k_1 of the
  permutation argument), TWO_ADICITY 32, POWER_OF_TWO_GENERATOR
  7277203076849721926;
- `goldilocks_extensions.rs`: F_p[X] / (X^2 - W) with W = 7;
- `extension_algebra.rs`: ExtensionAlgebra<F::Extension, 2>, pairs of
  extension elements with the same W, in which the extension gates evaluate
  their constraints at an extension point.

A base element is an int in [0, p); an extension element is an `Ext`.
"""

from __future__ import annotations

P = 0xFFFFFFFF00000001
W = 7
MULTIPLICATIVE_GROUP_GENERATOR = 14293326489335486720
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 7277203076849721926


def inv(a: int) -> int:
    a %= P
    if a == 0:
        raise ZeroDivisionError("inverse of zero in the Goldilocks field")
    return pow(a, P - 2, P)


def primitive_root_of_unity(n_log: int) -> int:
    """A generator of the multiplicative subgroup of order 2^n_log."""
    assert 0 <= n_log <= TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - n_log), P)


def reverse_bits(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


class Ext:
    """a + b X with X^2 = W."""

    __slots__ = ("a", "b")

    def __init__(self, a: int, b: int = 0):
        self.a = a % P
        self.b = b % P

    @staticmethod
    def of(x) -> "Ext":
        return x if isinstance(x, Ext) else Ext(x)

    def __add__(self, o):
        o = Ext.of(o)
        return Ext(self.a + o.a, self.b + o.b)

    __radd__ = __add__

    def __sub__(self, o):
        o = Ext.of(o)
        return Ext(self.a - o.a, self.b - o.b)

    def __rsub__(self, o):
        return Ext.of(o) - self

    def __neg__(self):
        return Ext(-self.a, -self.b)

    def __mul__(self, o):
        if isinstance(o, int):
            return Ext(self.a * o, self.b * o)
        return Ext(self.a * o.a + W * self.b * o.b, self.a * o.b + self.b * o.a)

    __rmul__ = __mul__

    def __eq__(self, o):
        o = Ext.of(o)
        return self.a == o.a and self.b == o.b

    def __hash__(self):
        return hash((self.a, self.b))

    def __repr__(self):
        return f"Ext({self.a}, {self.b})"

    def inverse(self) -> "Ext":
        d = inv(self.a * self.a - W * self.b * self.b)
        return Ext(self.a * d, -self.b * d)

    def __truediv__(self, o):
        o = Ext.of(o)
        return self * (o.inverse() if isinstance(o, Ext) else inv(o))

    def __pow__(self, n: int):
        out, base = Ext(1), self
        while n:
            if n & 1:
                out = out * base
            base = base * base
            n >>= 1
        return out

    def is_zero(self) -> bool:
        return self.a == 0 and self.b == 0


ZERO, ONE = Ext(0), Ext(1)


def product(xs) -> Ext:
    out = ONE
    for x in xs:
        out = out * x
    return out


class Alg:
    """ExtensionAlgebra<F::Extension, 2>: x0 + x1 Y with Y^2 = W, x0, x1 in
    the extension. `of_wires` reads it from two consecutive wires, and
    `parts` gives the two extension components a constraint is made of."""

    __slots__ = ("x0", "x1")

    def __init__(self, x0, x1=ZERO):
        self.x0 = Ext.of(x0)
        self.x1 = Ext.of(x1)

    @staticmethod
    def of_wires(wires, start: int) -> "Alg":
        return Alg(wires[start], wires[start + 1])

    def __add__(self, o):
        return Alg(self.x0 + o.x0, self.x1 + o.x1)

    def __sub__(self, o):
        return Alg(self.x0 - o.x0, self.x1 - o.x1)

    def __mul__(self, o):
        if not isinstance(o, Alg):  # a scalar of the extension or the field
            return Alg(self.x0 * o, self.x1 * o)
        return Alg(self.x0 * o.x0 + self.x1 * o.x1 * W, self.x0 * o.x1 + self.x1 * o.x0)

    def parts(self) -> list:
        return [self.x0, self.x1]
