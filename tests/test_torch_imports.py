"""The port's import boundary and device dispatch, on a machine without CUDA.

- Importing every port module (and bench_torch.py) loads no JAX and nothing
  of the JAX package; no source file of the port, nor bench_torch.py, holds
  an import of either at any depth of nesting; each of the port's paths
  run on the CPU at a tiny size (a forward, the gate zoo, the native ingest
  and the stream, the command line, a shape circuit, a mesh of two gloo
  processes, the profile) loads neither, in its process or in a spawned
  rank.
- One forward of each benchmark configuration's template at test size,
  every field wrapper on its card path with the kernels' own order in
  PyTorch standing in for the library, launches each kernel as often as on
  the card and gives the plain path's verdicts.
- On CPU tensors the wrappers take their plain versions and never touch the
  kernel library (the field kernels' Horner sums too).
- Without CUDA, the entry points (TorchVerifier, PoseidonConstants,
  verify_batch) raise unless given device="cpu", building the kernels
  raises, and a wrapper given a non-CPU tensor raises instead of falling
  back."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch import verifier_torch as vt
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops import hash as th
from plonky2_verifier_tpu_torch.ops import poseidon as tp
from torch_threads import child_env, one_torch_thread  # noqa: F401  (one_torch_thread: autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "plonky2_verifier_tpu_torch",
    "plonky2_verifier_tpu_torch.kernels",
    "plonky2_verifier_tpu_torch.ops.field",
    "plonky2_verifier_tpu_torch.ops.poseidon",
    "plonky2_verifier_tpu_torch.ops.hash",
    "plonky2_verifier_tpu_torch.compiler.levelize",
    "plonky2_verifier_tpu_torch.compiler.gates_torch",
    "plonky2_verifier_tpu_torch.verifier_torch",
    "plonky2_verifier_tpu_torch.types",
    "plonky2_verifier_tpu_torch.gate_parser",
    "plonky2_verifier_tpu_torch.gates",
    "plonky2_verifier_tpu_torch.compiler",
    "plonky2_verifier_tpu_torch.compiler.template",
    "plonky2_verifier_tpu_torch.compiler.flatten",
    "plonky2_verifier_tpu_torch.golden.verifier",
    "plonky2_verifier_tpu_torch.golden.challenges",
    "plonky2_verifier_tpu_torch.models.cache",
    "plonky2_verifier_tpu_torch.models.gate_zoo",
    "plonky2_verifier_tpu_torch.prover.prove",
    "plonky2_verifier_tpu_torch.tools.probe_kernels",
    "plonky2_verifier_tpu_torch.metrics",
    "plonky2_verifier_tpu_torch.native",
    "plonky2_verifier_tpu_torch.parallel",
    "plonky2_verifier_tpu_torch.parallel.stream",
    "plonky2_verifier_tpu_torch.parallel.mesh",
    "plonky2_verifier_tpu_torch.graft_entry",
    "plonky2_verifier_tpu_torch.tools.distributed_dryrun",
    "plonky2_verifier_tpu_torch.tools.check_hash_kernels",
    "plonky2_verifier_tpu_torch.tools.check_field_kernels",
    "plonky2_verifier_tpu_torch.tools.bench_poseidon",
    "plonky2_verifier_tpu_torch.tools.profile_verifier",
    "plonky2_verifier_tpu_torch.tools.lookup_device_check",
    "plonky2_verifier_tpu_torch.__main__",
    "plonky2_verifier_tpu_torch.tools.stream_verify",
    "plonky2_verifier_tpu_torch.tools.bench_ingest",
    "plonky2_verifier_tpu_torch.tools.shape_circuits",
    "plonky2_verifier_tpu_torch.bench",
    "bench_torch",
]
FORBIDDEN = ["jax", "jaxlib", "plonky2_verifier_tpu"]
_LOADED_FORBIDDEN = f"[m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("module", PORT_MODULES)
def test_import_loads_no_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        f"bad = {_LOADED_FORBIDDEN}\n"
        "assert not bad, bad\n"
    )
    env = child_env()
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _port_sources():
    files = [os.path.join(ROOT, "bench_torch.py")]
    for folder, _, names in os.walk(os.path.join(ROOT, "plonky2_verifier_tpu_torch")):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_source_imports_jax_or_the_jax_package():
    """An `import` or `from` of a forbidden package anywhere in the port's
    sources or bench_torch.py, inside functions too."""
    files = _port_sources()
    assert len(files) > 40
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


PATH_PROLOGUE = """
import json, os, sys, tempfile
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof

TINY = {"n_arith_rows": 13, "num_query_rounds": 2, "proof_of_work_bits": 2}


def loaded():
    return LOADED


def tiny():
    common, vkey, pwp = get_fixture_proof("fibonacci", **TINY)
    return CircuitTemplate(common), common, vkey, pwp


def mesh_rank(batch):
    from plonky2_verifier_tpu_torch.parallel import ShardedVerifier, make_mesh

    tpl, _, vkey, pwp = tiny()
    sv = ShardedVerifier(tpl, make_mesh(2, 1), device="cpu")
    ok = sv.gather(sv(sv.shard_arrays(flatten_proofs(tpl, [(vkey, pwp)] * batch)))["ok"]).tolist()
    return ok, loaded()


if __name__ == "__main__":
"""
# each path as the body of the script's main block: it runs the path and
# asserts what it gave
PATHS = {
    "forward": """
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier
    tpl, _, vkey, pwp = tiny()
    v = TorchVerifier(tpl, device="cpu")
    assert v.to_host(v(v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * 2)))).tolist() == [True, True]
""",
    "gate zoo": """
    from plonky2_verifier_tpu_torch.verifier_torch import verify_batch
    common, vkey, pwp = get_fixture_proof("gate_zoo", num_query_rounds=2, proof_of_work_bits=2)
    tpl = CircuitTemplate(common)
    assert tpl.n_lookup and verify_batch(tpl, flatten_proofs(tpl, [(vkey, pwp)] * 2), device="cpu")["ok"].tolist() == [True, True]
""",
    "ingest and stream": """
    from plonky2_verifier_tpu_torch import native
    from plonky2_verifier_tpu_torch.parallel import StreamVerifier
    from plonky2_verifier_tpu_torch.tools.stream_verify import proof_stream
    tpl, _, vkey, pwp = tiny()
    items, bad = proof_stream(vkey, pwp, 5, 4, raw=True)
    m = StreamVerifier(tpl, 8, raw_json=True, device="cpu").run(items)
    assert native.get_fastload() is not None and (m.proofs, m.rejected, m.batches) == (5, bad, 1) == (5, 1, 1)
""",
    "command line": """
    from plonky2_verifier_tpu_torch.__main__ import main
    _, common, vkey, pwp = tiny()
    with tempfile.TemporaryDirectory() as folder:
        for obj, kind in [(common, "common"), (vkey, "vkey"), (pwp, "proof")]:
            with open(os.path.join(folder, f"fib_{kind}.json"), "w") as f:
                json.dump(obj.to_json(), f)
        assert main(["verify", os.path.join(folder, "fib"), "--batch", "2", "--device", "cpu"]) == 0
""",
    "shape circuit": """
    from plonky2_verifier_tpu_torch.prover.prove import prove
    from plonky2_verifier_tpu_torch.tools import shape_circuits as sc
    fx = sc.grid_fixture(*sc.GRID[0])
    sc.check_circuit("grid", fx.common, *prove(fx), sc.GRID_FAULTS, device="cpu")
""",
    "mesh": """
    from plonky2_verifier_tpu_torch.parallel import run_ranks
    ranks = run_ranks(mesh_rank, 2, (4,), threads=1, timeout_s=240)
    assert ranks == [([True] * 4, [])] * 2, ranks  # each rank's gathered verdict, and what the rank loaded
""",
    "profile": """
    from plonky2_verifier_tpu_torch.tools.profile_verifier import stage_times
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier
    tpl, _, vkey, pwp = tiny()
    v = TorchVerifier(tpl, device="cpu")
    assert stage_times(v, v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * 2)))["stages_ms"]  # the profile's traced call
""",
}


@pytest.mark.parametrize("path", list(PATHS))
def test_path_loads_no_jax(tmp_path, path):
    """Each of the port's paths at a tiny size on the CPU loads no JAX and
    nothing of the JAX package; the mesh checks its spawned ranks too. The
    script is a file: spawned children import their parent's main module by
    its path."""
    script = tmp_path / "path.py"
    script.write_text(PATH_PROLOGUE.replace("LOADED", _LOADED_FORBIDDEN) + PATHS[path] + "    bad = loaded()\n    assert not bad, bad\n")
    env = child_env()
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


CARD_PATHS = """
import sys, torch
from plonky2_verifier_tpu_torch import kernels, verifier_torch as vt
from plonky2_verifier_tpu_torch.compiler.gates_torch import INPUT_KINDS, GateProgram
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.tools.check_field_kernels import (coset_fold_rows_plain, gate_programs, golden_packed_program,
    horner_rows_plain, lookup_checks_rows_plain, partial_products_rows_plain)

class Lib:  # the library's field entry points by their plain versions
    horner = staticmethod(horner_rows_plain)
    gate_program = staticmethod(golden_packed_program)
    coset_fold = staticmethod(coset_fold_rows_plain)
    partial_products = staticmethod(partial_products_rows_plain)
    lookup_checks = staticmethod(lookup_checks_rows_plain)

(_, lp), = [p for p in gate_programs() if p[0] == "fibonacci"]
prog = GateProgram(lp, "cpu")
before = set(sys.modules)
kernels.load = lambda: Lib()
x = tf.constant(5, (2, 3), "cpu")
vt._horner_kernel(tf.GExt(x, x), tf.GExt(x[:, 0], x[:, 0]))
prog._forward_kernel({k: tf.ext_zeros((2, lp.input_slots[k][1]), "cpu") for k in INPUT_KINDS}, (2,))
e = lambda *shape: tf.GExt(tf.constant(3, shape, "cpu"), tf.constant(5, shape, "cpu"))
vt._coset_folds_kernel([tf.constant(2, (2, 3, 2, 2), "cpu")], [x], [e(2)], [tf.constant(1, (2, 2), "cpu")])
vt._partial_products_kernel(e(2), e(2), e(2, 1), e(2, 1), e(2, 1), e(2, 4), e(2, 4), x[:, :1], x[:, :1], e(2), x[0, :2].repeat(2), 2)
coeffs, offsets = vt.lookup_tables(type("C", (), {"config": type("F", (), {"num_routed_wires": 6}), "luts": [[(1, 2)]]}), "cpu")
vt._lookup_checks_kernel(e(2, 5), e(2, 6), e(2, 2), e(2, 2), [(x[:, 0],) * 4], coeffs, offsets, 6, 4)
print(sorted(m for m in set(sys.modules) - before if m.split(".")[0] == "sympy" or "symbolic_shapes" in m))
"""


def test_card_paths_import_nothing_at_their_first_call():
    """The wrappers' card paths (Horner sum, gate program, coset folds,
    partial products, lookup argument),
    with the library's plain stand-ins, load no sympy: torch.broadcast_shapes
    imports torch.fx's symbolic shapes at its first call, which cost a fresh
    process ~3 s of its first verifier call on the card."""
    env = child_env()
    res = subprocess.run([sys.executable, "-c", CARD_PATHS], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"

CARD_FORWARD = """
import json, sys, torch
from plonky2_verifier_tpu_torch import kernels, verifier_torch as vt
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
from plonky2_verifier_tpu_torch.compiler.gates_torch import GateProgram
from plonky2_verifier_tpu_torch.ops import field as tf, hash as th, poseidon as tp
from plonky2_verifier_tpu_torch.tools.check_hash_kernels import PlainLibrary
from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

FIXTURE
tpl = CircuitTemplate(common)
arrays = flatten_proofs(tpl, [(vkey, pwp)] * 2)
arrays["openings1"][1, 0, 0] ^= 1
v = TorchVerifier(tpl, device="cpu")
v._gate_packed = v.gates.pack(v._gate_out_slots)  # as a verifier on the card packs it
lib = PlainLibrary(tp.PoseidonConstants("cpu"))  # the kernels' own order on the CPU, its launches counted
before = set(sys.modules)
kernels.load = lambda: lib
# the field wrappers' card paths, on CPU tensors
tf.pow_grouped, tf.inv_grouped, vt.horner_ext = tf._pow_grouped_kernel, tf._inv_grouped_kernel, vt._horner_kernel
vt.partial_products, vt.lookup_checks, vt.gate_filter = vt._partial_products_kernel, vt._lookup_checks_kernel, vt._gate_filter_kernel
GateProgram.forward = GateProgram._forward_kernel

def counted(name, fn, launches):  # a wrapper on its plain path, its launches counted as the library counts them
    def run(*a, **kw):
        lib.launches[name] += launches(*a)
        return fn(*a, **kw)
    return run

rows = lambda t, tail: t.shape[:-tail].numel()
tp.permutation_scan = counted("permutation_scan", tp.permutation_scan, lambda data, ov_idx, *a: bool(data.shape[0] and ov_idx.shape[0]))
th.sponge_rows = counted("sponge_rows", th.sponge_rows, lambda r, *a: bool(rows(r, 1)))
th.sponge_rows_grouped = counted("sponge_rows_grouped", th.sponge_rows_grouped, lambda rs, *a: -(-sum(bool(rows(r, 1)) for r in rs) // 16))
th.merkle_fold = counted("merkle_fold", th.merkle_fold, lambda d, *a: bool(rows(d, 1)))
vt.horner_scaled = counted("horner", vt.horner_scaled, lambda values, scale: bool(scale.numel()))
vt.coset_folds = counted("coset_fold", vt.coset_folds, lambda evals, *a: bool(evals and evals[0].numel()))
out = v(v.prepare(arrays))
print(json.dumps({"ok": out["ok"].tolist(), "eqs": out["eqs_ok"].tolist(), "fri": out["fri_ok"].tolist(), "launches": lib.launches,
                  "merkle": (1 if tpl.initial_path_len else 0) + sum(1 for st in tpl.steps if st["path_len"]), "steps": len(tpl.steps),
                  "lookups": tpl.common.num_lookup_polys > 0, "constraints": tpl.common.num_gate_constraints > 0,
                  "loaded": sorted(m for m in set(sys.modules) - before if m.split(".")[0] == "sympy" or "symbolic_shapes" in m)}))
"""
# the benchmark configurations' templates at test size: lines that set common, vkey and pwp
TEMPLATES = {
    "fibonacci": """from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
common, vkey, pwp = get_fixture_proof("fibonacci", n_arith_rows=60, num_query_rounds=2, proof_of_work_bits=2)  # degree 6: a fold step""",
    "gate zoo": """from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
common, vkey, pwp = get_fixture_proof("gate_zoo", num_query_rounds=2, proof_of_work_bits=2)""",
    "big lut": """from plonky2_verifier_tpu_torch.models.lookup import big_lut_fixture
from plonky2_verifier_tpu_torch.prover.prove import prove
fx = big_lut_fixture(table_size=64, inputs=(51, 5), num_query_rounds=2, proof_of_work_bits=2, seed=5)
common, (vkey, pwp) = fx.common, prove(fx)""",
}


@pytest.mark.parametrize("template", list(TEMPLATES))
def test_a_forward_through_the_grouped_card_paths_with_a_stand_in_library(template):
    """A forward of each benchmark configuration's template at test size
    (fibonacci, the gate zoo, Plonky2's big lookup table), its field wrappers
    on their card paths (ops/field._pow_grouped_kernel, _inv_grouped_kernel,
    the Horner sum's, the gate program's and the three stage kernels') with
    the library replaced by the kernels' own order in PyTorch
    (PlainLibrary), the hash wrappers and horner_scaled and the coset folds
    counted as the library counts: every counter of one forward as on the
    card -- the scan, the public-input sponge and the grouped sponge once,
    the Merkle walk once a path, the Horner sum 7 times, every exponentiation
    and every inversion in one launch each, the gate program once, the coset
    folds once where there is a fold step, L0 with the partial products
    once, the lookup argument once where there are lookups, the gate filter
    once -- the verdicts of a planted fault (lane 1's first opening), and
    no sympy loaded at the first call."""
    code = CARD_FORWARD.replace("FIXTURE", TEMPLATES[template])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=child_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] == out["eqs"] == [True, False]
    assert out["fri"][0]
    assert out["launches"] == {
        "permutation": 0, "permutation_scan": 1, "sponge_rows": 1, "sponge_rows_grouped": 1, "merkle_fold": out["merkle"], "horner": 7,
        "inv_grouped": 1, "pow_grouped": 1, "gate_program": 1, "coset_fold": 1 if out["steps"] else 0, "partial_products": 1,
        "lookup_checks": 1 if out["lookups"] else 0, "gate_filter": 1 if out["constraints"] else 0,
    }
    assert (template == "fibonacci") == bool(out["steps"]) != out["lookups"] and out["merkle"] and out["constraints"]
    assert out["loaded"] == []


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)


def _rand(seed, shape):
    return tf.from_u64(np.random.default_rng(seed).integers(0, tf.P, size=shape, dtype=np.uint64), "cpu")


def test_cpu_wrappers_take_plain_path(no_library):
    consts = tp.PoseidonConstants("cpu")
    x = _rand(0, (3, 2, 12))
    assert torch.equal(tp.permutation(x, consts), tp.permutation_plain(x, consts))
    rows = _rand(1, (5, 20))
    assert torch.equal(th.sponge_rows(rows, 20, consts), th.sponge_rows_plain(rows, 20, consts))
    grouped = th.sponge_rows_grouped([rows, _rand(9, (2, 3, 9))], consts)
    assert torch.equal(grouped[0], th.sponge_rows_plain(rows, 20, consts)) and grouped[1].shape == (2, 3, 4)
    dig, sibs = _rand(2, (2, 3, 4)), _rand(3, (2, 3, 5, 4))
    idx = torch.arange(6, dtype=torch.int64).reshape(2, 3) * 37
    assert torch.equal(th.merkle_fold(dig, idx, sibs, 5, consts), th.merkle_fold_plain(dig, idx, sibs, 5, consts))
    data = _rand(8, (3, 30))
    ov_idx = torch.arange(48, dtype=torch.int64).reshape(4, 12) % 30
    ov_mask = (torch.arange(48).reshape(4, 12) % 3) == 0
    states = tp.permutation_scan(data, ov_idx, ov_mask, consts)
    assert torch.equal(states, tp.permutation_scan_plain(data, ov_idx, ov_mask, consts))
    assert states.shape == (4, 3, 12)
    values, point = tf.GExt(_rand(10, (3, 7)), _rand(11, (3, 7))), tf.GExt(_rand(12, (3,)), _rand(13, (3,)))
    got, want = vt.horner_ext(values, point), vt.horner_ext_plain(values, point)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    scale = _rand(14, (3, 2))
    got, want = vt.horner_scaled(values, scale), vt.horner_scaled_plain(values, scale)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


def _tiny_template():
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
    from plonky2_verifier_tpu_torch.prover.prove import prove

    fx = fibonacci_fixture(n_arith_rows=13, num_query_rounds=2, proof_of_work_bits=2)
    tpl = CircuitTemplate(fx.common)
    return tpl, flatten_proofs(tpl, [prove(fx)] * 2)


def test_entry_points_default_to_the_card_and_raise_without_one():
    _no_cuda()
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier, verify_batch

    tpl, arrays = _tiny_template()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVerifier(tpl)
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_batch(tpl, arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.PoseidonConstants()
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.resolve_device(None)
    out = verify_batch(tpl, arrays, device="cpu")
    assert out["ok"].tolist() == [True, True] and out["ok"].dtype == np.bool_
    v = TorchVerifier(tpl, device="cpu")
    assert {b.device.type for b in v.buffers()} == {"cpu"}


def test_field_constructors_require_a_device():
    for call in (
        lambda: tf.from_u64(np.zeros(2, dtype=np.uint64)),
        lambda: tf.constant(1, (2,)),
        lambda: tf.zeros((2,)),
        lambda: tf.ext_constant(1, shape=(2,)),
        lambda: tf.ext_zeros((2,)),
    ):
        with pytest.raises(TypeError, match="device"):
            call()


def test_build_raises_without_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.build()


def test_non_cpu_tensor_raises_instead_of_falling_back():
    _no_cuda()
    consts = tp.PoseidonConstants("cpu")
    meta = torch.empty((4, 12), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.permutation(meta, consts)
    with pytest.raises(RuntimeError, match="CUDA"):
        th.sponge_rows(torch.empty((4, 9), dtype=torch.int64, device="meta"), 9, consts)
    with pytest.raises(RuntimeError, match="CUDA"):  # one matrix off the CPU is enough
        th.sponge_rows_grouped([_rand(9, (4, 9)), torch.empty((4, 9), dtype=torch.int64, device="meta")], consts)
    with pytest.raises(RuntimeError, match="CUDA"):
        vt.horner_ext(torch.empty((4, 9), dtype=torch.int64, device="meta"), torch.empty((4,), dtype=torch.int64, device="meta"))


def test_kernel_input_checks_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels._check_tensor(torch.zeros((2, 12), dtype=torch.int64), "state", (None, 12))


def test_wrappers_reject_wrong_widths():
    consts = tp.PoseidonConstants("cpu")
    with pytest.raises(ValueError):
        th.sponge_rows(_rand(4, (2, 7)), 8, consts)
    with pytest.raises(ValueError):
        th.merkle_fold(_rand(5, (2, 4)), torch.zeros(2, dtype=torch.int64), _rand(6, (2, 3, 4)), 2, consts)
    with pytest.raises(ValueError):
        tp.permutation_plain(_rand(7, (2, 8)), consts)
