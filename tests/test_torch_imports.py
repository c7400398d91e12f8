"""The port's import boundary and device dispatch, on a machine without CUDA.

- Importing every port module (and chip_smoke.py) loads no JAX and nothing
  of the JAX package; no source file of the port, nor chip_smoke.py, holds
  an import of either at any depth of nesting; a CPU rehearsal of
  chip_smoke's paths (main, gate zoo, ingest, stream, command line, shapes,
  the mesh of processes and the profile) loads neither, in this process or
  in a spawned rank.
- On CPU tensors the wrappers take their plain versions and never touch the
  kernel library.
- Without CUDA, the entry points (TorchVerifier, PoseidonConstants,
  verify_batch) raise unless given device="cpu", building the kernels
  raises, a wrapper given a non-CPU tensor raises instead of falling back,
  and chip_smoke.py exits non-zero without printing a result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch.ops import field as tf
from plonky2_verifier_tpu_torch.ops import hash as th
from plonky2_verifier_tpu_torch.ops import poseidon as tp

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
    "plonky2_verifier_tpu_torch.tools.bench_poseidon",
    "plonky2_verifier_tpu_torch.tools.profile_verifier",
    "plonky2_verifier_tpu_torch.tools.lookup_device_check",
    "plonky2_verifier_tpu_torch.__main__",
    "plonky2_verifier_tpu_torch.tools.stream_verify",
    "plonky2_verifier_tpu_torch.tools.bench_ingest",
    "plonky2_verifier_tpu_torch.tools.shape_circuits",
    "chip_smoke",
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
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for folder, _, names in os.walk(os.path.join(ROOT, "plonky2_verifier_tpu_torch")):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_source_imports_jax_or_the_jax_package():
    """An `import` or `from` of a forbidden package anywhere in the port's
    sources or chip_smoke.py, inside functions too."""
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


REHEARSAL = """
import sys, torch
import chip_smoke as cs
from plonky2_verifier_tpu_torch import kernels
from plonky2_verifier_tpu_torch.ops import hash as th, poseidon as tp

consts = tp.PoseidonConstants("cpu")

class Lib:  # stands in for the kernel library: counts, then runs the plain version
    def reset_launches(self):
        self.launches = dict.fromkeys(kernels.COUNTERS, 0)

lib = Lib(); lib.reset_launches()
from plonky2_verifier_tpu_torch.tools.check_hash_kernels import new_checks
checks = new_checks()
def counted(name, fn):
    def run(*a):
        lib.launches[name] += 1
        return fn(*a)
    return run
tp.permutation_scan = counted("permutation_scan", tp.permutation_scan)
th.sponge_rows = counted("sponge_rows", th.sponge_rows)
th.sponge_rows_grouped = counted("sponge_rows_grouped", th.sponge_rows_grouped)
th.merkle_fold = counted("merkle_fold", th.merkle_fold)
cs.DEVICE, cs.BATCH = "cpu", 6
cs.STANDARD = {"n_arith_rows": 13, "num_query_rounds": 2, "proof_of_work_bits": 2}
cs.ZOO = {"num_query_rounds": 2, "proof_of_work_bits": 2}
cs.ZOO_BATCHES, cs.ZOO_TIMED_CALLS = [7, 8], 0
torch.cuda.synchronize = lambda: None
v, dev, launches, fib = cs.main_path(lib, checks)
assert launches["permutation_scan"] == 1 and launches["merkle_fold"] > 0, launches
assert launches["sponge_rows"] == 1 and launches["sponge_rows_grouped"] == 1, launches
prover = cs.start_prover("gate_zoo", cs.ZOO)
zoo_launches = cs.zoo_path(lib, cs.zoo_fixture(prover), checks)
assert prover.returncode == 0
assert sorted(zoo_launches) == [7, 8] and all(n["sponge_rows_grouped"] == 1 for n in zoo_launches.values()), zoo_launches
bad = LOADED
assert not bad, bad
"""


def test_chip_smoke_main_path_rehearsal_loads_no_jax():
    """chip_smoke.main_path and zoo_path (its fixture proved by the child
    process) end to end on the CPU at a tiny size, the kernel library
    replaced by counters around the plain versions: every phase passes, the
    launch checks hold, and no forbidden module was loaded."""
    code = REHEARSAL.replace("LOADED", _LOADED_FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "rejected lanes [0, 1, 2, 3, 4, 5]\n" in res.stdout
    assert res.stdout.count("rejected lanes [0, 1, 2, 3, 4, 5, 6]\n") == 2  # the zoo path, each batch
    assert "gate zoo batch 8: lane 0 transcript equals golden" in res.stdout


SERVING_REHEARSAL = REHEARSAL[: REHEARSAL.index("cs.DEVICE, cs.BATCH")] + """
import json, os, time
from plonky2_verifier_tpu_torch import native
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
from plonky2_verifier_tpu_torch.tools import shape_circuits as sc

cs.DEVICE, cs.BATCH = "cpu", 4
cs.INGEST_PROOFS, cs.STREAM_PROOFS, cs.STREAM_CORRUPT_EVERY = 5, 10, 4
cs.CLI_BATCH, cs.CLI_REPEAT = 2, 3
torch.cuda.synchronize = lambda: None

def fixture(queries):
    common, vkey, pwp = get_fixture_proof("fibonacci", n_arith_rows=13, num_query_rounds=queries, proof_of_work_bits=2)
    return CircuitTemplate(common), common, vkey, pwp

fib = fixture(6)
ingest = cs.ingest_phase(fib)
assert os.path.dirname(native.get_fastload().__file__).endswith(os.path.join("plonky2_verifier_tpu_torch", "native", "_build"))
launches, snap = cs.stream_path(lib, fib, 1.0, ingest)
assert snap["proofs"] == 10, snap
assert launches["permutation_scan"] == 3 and launches["sponge_rows_grouped"] == 3, launches
cli = cs.cli_path(lib, {"fibonacci": fib, "other": fixture(2)}, checks)
assert cli["permutation_scan"] == 4 and cli["sponge_rows_grouped"] == 4, cli
sc.GRID, sc.FUZZ_SEEDS = [(4, 2, 0)], [13]
shapes = cs.shapes_path(lib, checks)
assert shapes["permutation_scan"] == 4 and shapes["merkle_fold"] == 4, shapes
bad = LOADED
assert not bad, bad
"""


def test_chip_smoke_serving_phases_rehearsal_loads_no_jax():
    """chip_smoke's ingest, stream, command-line and shape phases end to end
    on the CPU (6 queries, batch 4; 10 proofs with every 4th corrupt; one grid
    point and one fuzz seed), the kernel library replaced by counters around
    the plain versions: every phase passes, the launch checks hold, the native
    ingest built in the port's own folder ran, no forbidden module was loaded."""
    code = SERVING_REHEARSAL.replace("LOADED", _LOADED_FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout + res.stderr
    final = json.loads(next(l for l in res.stdout.splitlines() if l.startswith("stream: final ")).removeprefix("stream: final "))
    assert (final["proofs"], final["accepted"], final["rejected"], final["batches"]) == (10, 8, 2, 3)
    assert "cli stream: exit code 0" in res.stdout and "verified (torch, batch 4" in res.stdout
    assert "shape grid (4, 2, 0):" in res.stdout and "shape fuzz 13:" in res.stdout


MESH_REHEARSAL = """
import sys, torch
import chip_smoke as cs
from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
from plonky2_verifier_tpu_torch.parallel import run_ranks
from plonky2_verifier_tpu_torch.tools.check_hash_kernels import new_checks

if __name__ == "__main__":
    cs.DEVICE, cs.BATCH = "cpu", 4
    cs.STANDARD = {"n_arith_rows": 13, "num_query_rounds": 2, "proof_of_work_bits": 2}
    cs.MESHES, cs.MESH_BATCH, cs.MESH_TIMED_CALLS, cs.MESH_TIMEOUT_S = [(2, 2)], 8, 0, 240
    cs.MESH_STREAM_BATCH, cs.MESH_STREAM_PROOFS, cs.STREAM_CORRUPT_EVERY = 4, 10, 4
    cs.PROFILE = [("fibonacci6", 2)]
    torch.cuda.synchronize = lambda: None
    common, vkey, pwp = get_fixture_proof("fibonacci", **cs.STANDARD)
    checks = new_checks()
    cs.mesh_path((CircuitTemplate(common), common, vkey, pwp), checks, {"proofs_per_sec": 1.0, "steady_proofs_per_sec": 1.0}, 1.0)
    assert all(c.cases > 0 and c.max_abs_err == 0 for c in checks.values()), {k: c.cases for k, c in checks.items()}
    cs.profile_path()
    # a rank of run_ranks: what parallel.mesh's entry point of the children has loaded
    in_ranks = run_ranks(eval, 2, ("LOADED".replace("sys.modules", "__import__('sys').modules"),), threads=1, timeout_s=120)
    assert in_ranks == [[], []], in_ranks
    bad = LOADED
    assert not bad, bad
"""


def test_chip_smoke_mesh_and_profile_rehearsal_loads_no_jax(tmp_path):
    """chip_smoke.mesh_path (one 2 x 2 mesh of gloo processes and the 2 x 1
    mesh stream) and profile_path on the CPU at a tiny size: every rank's
    verdicts equal one process's, the last rank holds the wrappers at its
    shapes, the stream's global counts hold on both ranks; neither this
    process nor a spawned rank loaded a forbidden module. The script is a
    file: spawned children import their parent's main module by its path."""
    script = tmp_path / "rehearse_mesh.py"
    script.write_text(MESH_REHEARSAL.replace("LOADED", _LOADED_FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "mesh 2 x 2: 4 processes on one card, global batch 8 (4 lanes, 1 queries a rank)" in res.stdout
    assert "n_valid 6 on every rank, rejected lanes [1, 7]" in res.stdout
    assert "mesh stream 2 x 1: 10 proofs at global batch 4, counts [10, 8, 2, 3] on every rank" in res.stdout
    assert "profile fibonacci6 batch 2" in res.stdout


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


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
