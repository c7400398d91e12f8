"""Disk cache for generated fixtures + proofs (fixtures/*.json).

Proof generation is host-side Python and takes seconds; benches and entry
points reuse cached artifacts keyed by model name + parameters. The JSON
round-trips through the Plonky2 serialization codecs, which doubles as a
codec regression test.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Tuple

from ..types import (
    CommonCircuitData,
    ProofWithPublicInputs,
    VerifierOnlyCircuitData,
    load_common,
    load_proof,
    load_vkey,
)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "fixtures")


def get_fixture_proof(
    name: str, **params
) -> Tuple[CommonCircuitData, VerifierOnlyCircuitData, ProofWithPublicInputs]:
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    key = hashlib.sha256(json.dumps([name, sorted(params.items())]).encode()).hexdigest()[:12]
    base = os.path.join(FIXTURE_DIR, f"{name}_{key}")
    paths = [f"{base}_common.json", f"{base}_vkey.json", f"{base}_proof.json"]
    if all(os.path.exists(p) for p in paths):
        return load_common(paths[0]), load_vkey(paths[1]), load_proof(paths[2])

    if name == "fibonacci":
        from .fibonacci import fibonacci_fixture

        fx = fibonacci_fixture(**params)
    elif name == "poseidon_chain":
        from .poseidon_chain import poseidon_chain_fixture

        fx = poseidon_chain_fixture(**params)
    elif name == "gate_zoo":
        from .gate_zoo import gate_zoo_fixture

        fx = gate_zoo_fixture(**params)
    elif name in ("lookup", "multi_lookup"):
        from .lookup import lookup_fixture, multi_lookup_fixture

        fx = (lookup_fixture if name == "lookup" else multi_lookup_fixture)(**params)
    else:
        raise ValueError(f"unknown fixture model {name!r}")

    from ..prover.prove import prove

    vkey, pwp = prove(fx)
    for obj, path in zip([fx.common, vkey, pwp], paths):
        with open(path, "w") as f:
            json.dump(obj.to_json(), f)
    return load_common(paths[0]), load_vkey(paths[1]), load_proof(paths[2])
