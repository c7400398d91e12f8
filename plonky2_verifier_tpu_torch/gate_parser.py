"""Parser for Plonky2's gate serialization strings.

Plonky2 serializes gate types as Rust ``Debug``-format strings with a few
ad-hoc decorations; this module parses that grammar into a `Gate` dataclass
and can re-serialize it (used by the fixture generator). Grammar per
reference spec Gate/Parser.hs:107-240; notable quirks:

- ``"BaseSumGate { num_limbs: 63 } + Base: 2"``
- ``"PoseidonGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH=12>"``
- struct gates with a ``_phantom: PhantomData<...>`` field and ``<D=2>`` suffix
  (CosetInterpolationGate, RandomAccessGate)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import List, Tuple

PHANTOM = "_phantom: PhantomData<plonky2_field::goldilocks_field::GoldilocksField>"


@dataclass(frozen=True)
class Gate:
    kind: str
    params: tuple = ()

    def __repr__(self):
        return f"Gate({self.kind}{list(self.params)})"


def _num_list(s: str) -> List[int]:
    s = s.strip()
    assert s.startswith("[") and s.endswith("]"), s
    body = s[1:-1].strip()
    if not body:
        return []
    return [int(x.strip()) for x in body.split(",")]


_STRUCT_RE = re.compile(r"^(\w+)\s*\{\s*(.*?)\s*\}\s*(.*)$", re.S)


def _fields(body: str) -> dict:
    """Split 'k1: v1, k2: v2, ...' respecting [...] brackets."""
    out = {}
    depth = 0
    cur = []
    parts = []
    for ch in body:
        if ch == "[" or ch == "<" or ch == "(":
            depth += 1
        elif ch == "]" or ch == ">" or ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    for part in parts:
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition(":")
        out[k.strip()] = v.strip()
    return out


def parse_gate(s: str) -> Gate:
    s = s.strip()
    if s == "NoopGate":
        return Gate("NoopGate")
    if s == "PublicInputGate":
        return Gate("PublicInputGate")
    m = re.match(r"^PoseidonGate\(PhantomData<[^>]*>\)<WIDTH=(\d+)>$", s)
    if m:
        return Gate("PoseidonGate", (int(m.group(1)),))
    m = re.match(r"^PoseidonMdsGate\(PhantomData<[^>]*>\)<WIDTH=(\d+)>$", s)
    if m:
        return Gate("PoseidonMdsGate", (int(m.group(1)),))

    m = _STRUCT_RE.match(s)
    if not m:
        return Gate("UnknownGate", (s,))
    name, body, suffix = m.group(1), m.group(2), m.group(3).strip()
    f = _fields(body)

    if name == "ArithmeticGate":
        return Gate("ArithmeticGate", (int(f["num_ops"]),))
    if name == "ArithmeticExtensionGate":
        return Gate("ArithmeticExtensionGate", (int(f["num_ops"]),))
    if name == "BaseSumGate":
        mb = re.match(r"^\+\s*Base:\s*(\d+)$", suffix)
        if not mb:
            return Gate("UnknownGate", (s,))
        return Gate("BaseSumGate", (int(f["num_limbs"]), int(mb.group(1))))
    if name == "CosetInterpolationGate":
        return Gate(
            "CosetInterpolationGate",
            (int(f["subgroup_bits"]), int(f["degree"]), tuple(_num_list(f["barycentric_weights"]))),
        )
    if name == "ConstantGate":
        return Gate("ConstantGate", (int(f["num_consts"]),))
    if name == "ExponentiationGate":
        return Gate("ExponentiationGate", (int(f["num_power_bits"]),))
    if name == "LookupGate":
        return Gate("LookupGate", (int(f["num_slots"]), tuple(_num_list(f["lut_hash"]))))
    if name == "LookupTableGate":
        return Gate(
            "LookupTableGate",
            (int(f["num_slots"]), tuple(_num_list(f["lut_hash"])), int(f["last_lut_row"])),
        )
    if name == "MulExtensionGate":
        return Gate("MulExtensionGate", (int(f["num_ops"]),))
    if name == "RandomAccessGate":
        return Gate(
            "RandomAccessGate",
            (int(f["bits"]), int(f["num_copies"]), int(f["num_extra_constants"])),
        )
    if name == "ReducingGate":
        return Gate("ReducingGate", (int(f["num_coeffs"]),))
    if name == "ReducingExtensionGate":
        return Gate("ReducingExtensionGate", (int(f["num_coeffs"]),))
    return Gate("UnknownGate", (s,))


def gate_to_string(g: Gate) -> str:
    k, p = g.kind, g.params
    if k == "NoopGate":
        return "NoopGate"
    if k == "PublicInputGate":
        return "PublicInputGate"
    if k == "PoseidonGate":
        return f"PoseidonGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH={p[0]}>"
    if k == "PoseidonMdsGate":
        return f"PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH={p[0]}>"
    if k == "ArithmeticGate":
        return f"ArithmeticGate {{ num_ops: {p[0]} }}"
    if k == "ArithmeticExtensionGate":
        return f"ArithmeticExtensionGate {{ num_ops: {p[0]} }}"
    if k == "BaseSumGate":
        return f"BaseSumGate {{ num_limbs: {p[0]} }} + Base: {p[1]}"
    if k == "CosetInterpolationGate":
        weights = ", ".join(str(x) for x in p[2])
        return (
            f"CosetInterpolationGate {{ subgroup_bits: {p[0]}, degree: {p[1]}, "
            f"barycentric_weights: [{weights}], {PHANTOM} }}<D=2>"
        )
    if k == "ConstantGate":
        return f"ConstantGate {{ num_consts: {p[0]} }}"
    if k == "ExponentiationGate":
        return f"ExponentiationGate {{ num_power_bits: {p[0]} }}"
    if k == "LookupGate":
        h = ", ".join(str(x) for x in p[1])
        return f"LookupGate {{ num_slots: {p[0]}, lut_hash: [{h}] }}"
    if k == "LookupTableGate":
        h = ", ".join(str(x) for x in p[1])
        return f"LookupTableGate {{ num_slots: {p[0]}, lut_hash: [{h}], last_lut_row: {p[2]} }}"
    if k == "MulExtensionGate":
        return f"MulExtensionGate {{ num_ops: {p[0]} }}"
    if k == "RandomAccessGate":
        return (
            f"RandomAccessGate {{ bits: {p[0]}, num_copies: {p[1]}, "
            f"num_extra_constants: {p[2]}, {PHANTOM} }}<D=2>"
        )
    if k == "ReducingGate":
        return f"ReducingGate {{ num_coeffs: {p[0]} }}"
    if k == "ReducingExtensionGate":
        return f"ReducingExtensionGate {{ num_coeffs: {p[0]} }}"
    if k == "UnknownGate":
        return p[0]
    raise ValueError(f"unknown gate kind {k}")
