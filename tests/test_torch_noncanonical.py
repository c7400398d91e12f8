"""The port keeps the JAX package's bits where a subtraction's subtrahend is
a raw proof word written as y + p (0 < y < 2^32 - 1) above the minuend + p.
ops/field.sub, the port's as the JAX package's (plonky2_verifier_tpu/ops/
field.py), is not exact mod p there; golden/ reduces its operands first and
gives other words (ROADMAP.md Queue 3 lists every such site). Two sites
subtract such a word:

- the SLDC transition's sldc - prev in the lookup argument
  (`verifier_torch.lookup_checks_plain`; on the card csrc/plonk.cu, whose
  order in PyTorch is `check_field_kernels.lookup_checks_rows_plain`),
- the selector factors' consts - x in `TorchVerifier._eval_selectors`, x the
  gate-selector columns of openings1.

Function by function on the CPU, no proof: the lookup fixture's template,
openings of random words with such subtrahends written in, through the port
(the plain version and the kernel's order) and through the JAX package's
`JaxVerifier._lookup_checks` / `_eval_selectors`: the same words. Each case
also shows that it reaches the inexact subtraction: the same elements
reduced first (golden/'s side) give other words on the probed lanes.

Tolerance: none (integers mod p, bit for bit)."""

import jax
import numpy as np
import pytest

from plonky2_verifier_tpu.compiler.template import CircuitTemplate as JaxTemplate
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu.verifier_jax import JaxVerifier
from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch import verifier_torch as vt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.golden import field as gf
from plonky2_verifier_tpu_torch.models.lookup import lookup_fixture
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops.field import GExt, to_u64
from plonky2_verifier_tpu_torch.tools.check_field_kernels import probe_sldc_subtrahends, words
from plonky2_verifier_tpu_torch.tools.check_hash_kernels import PlainLibrary
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

P = gf.P


@pytest.fixture(scope="module")
def verifiers():
    """The lookup fixture's template (2 rounds, 6 SLDC chunks, 80 routed
    wires, one table; several selector groups) in both packages; no proof."""
    common = lookup_fixture(num_query_rounds=4, proof_of_work_bits=4).common
    return common, vt.TorchVerifier(CircuitTemplate(common), device="cpu"), JaxVerifier(JaxTemplate(common))


def _port(a: np.ndarray) -> GExt:
    return GExt(tf.from_u64(a[..., 0], "cpu"), tf.from_u64(a[..., 1], "cpu"))


def _jax(a: np.ndarray):
    return jf.ext_from_u64(a[..., 0], a[..., 1])


def _words(x) -> np.ndarray:
    return np.stack([to_u64(x.re), to_u64(x.im)], axis=-1)


def test_lookup_checks_equal_jax_on_noncanonical_subtrahends(verifiers, monkeypatch):
    """Lanes 1-6 carry at every SLDC chunk's sldc - prev (one chunk a lane,
    both rounds) a subtrahend y + p above the minuend + p, lane 0 the words
    of words() (the p-edge band and x + p): the port's plain version and
    the kernel's order give JaxVerifier._lookup_checks' words; reduced
    first, each of lanes 1-6 reads otherwise."""
    common, tv, jv = verifiers
    tpl = tv.tpl
    r, n_polys = tpl.r, common.num_lookup_polys
    B = 1 + n_polys - 1
    rng = np.random.default_rng(31)
    arrays = {"lkp_sels": words(rng, (B, 4 + common.num_luts, 2)), "wires": words(rng, (B, tpl.num_wires, 2)),
              "lookup_zs": words(rng, (B, r * n_polys, 2)), "lookup_zs_next": words(rng, (B, r * n_polys, 2))}
    probe_sldc_subtrahends(rng, arrays["lookup_zs"], arrays["lookup_zs_next"], r, n_polys, range(1, B))
    deltas = [[rng.integers(0, P, size=B, dtype=np.uint64) for _ in range(4)] for _ in range(r)]
    port_deltas = [tuple(tf.from_u64(x, "cpu") for x in d) for d in deltas]
    names = ("lkp_sels", "wires", "lookup_zs", "lookup_zs_next")

    got = tv._lookup_checks(*[_port(arrays[k]) for k in names], port_deltas)
    lib = PlainLibrary(None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    order = vt._lookup_checks_kernel(*[_port(arrays[k]) for k in names], port_deltas, tv._lut_coeffs, tv._lut_off,
                                     common.config.num_routed_wires, common.quotient_degree_factor)
    ref = jax.jit(jv._lookup_checks)(*[_jax(arrays[k]) for k in names], [tuple(jf.from_u64(x) for x in d) for d in deltas])
    ref = np.stack([np.asarray(x) for x in jf.ext_to_u64(ref)], axis=-1)
    np.testing.assert_array_equal(_words(got), ref)
    np.testing.assert_array_equal(_words(order), ref)

    reduced = tv._lookup_checks(*[_port(arrays[k] % np.uint64(P)) for k in names], port_deltas)
    differs = (_words(reduced) != ref).any(axis=(1, 2))
    assert differs[1:].all(), differs


def test_eval_selectors_equal_jax_on_noncanonical_subtrahends(verifiers):
    """consts - x with x the gate-selector openings: lane 1 has every column
    written as y + p (n_gates < y < 2^32 - 1, above every gate-index factor;
    the UNUSED factor 2^32 - 1 stays above it), lanes 0 and 2 the words of
    words(): the port's _eval_selectors gives JaxVerifier's words; reduced
    first, lane 1 reads otherwise."""
    common, tv, jv = verifiers
    n_sel = tv.tpl.n_gate_selectors
    n_gates = len(common.selectors_info.selector_indices)
    rng = np.random.default_rng(32)
    sels = words(rng, (3, n_sel, 2))
    sels[1] = rng.integers(n_gates + 1, (1 << 32) - 1, size=(n_sel, 2), dtype=np.uint64) + np.uint64(P)
    got = tv._eval_selectors(_port(sels))
    ref = jv._eval_selectors(_jax(sels))
    ref = np.stack([np.asarray(x) for x in jf.ext_to_u64(ref)], axis=-1)
    np.testing.assert_array_equal(_words(got), ref)

    reduced = _words(tv._eval_selectors(_port(sels % np.uint64(P))))
    assert (reduced[1] != ref[1]).any()
