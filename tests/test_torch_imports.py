"""The port's import boundary and device dispatch, on a machine without CUDA.

- Importing every port module (and chip_smoke.py) loads no JAX and nothing
  of the JAX package; no source file of the port, nor chip_smoke.py, holds
  an import of either at any depth of nesting; a CPU rehearsal of
  chip_smoke.main_path loads neither.
- On CPU tensors the wrappers take their plain versions and never touch the
  kernel library.
- Without CUDA, the entry points (TorchVerifier, PoseidonConstants,
  verify_batch) raise unless given device="cpu", building the kernels
  raises, a wrapper given a non-CPU tensor raises instead of falling back,
  and chip_smoke.py exits non-zero without printing a result."""

import ast
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
v, dev, launches = cs.main_path(lib)
assert launches["permutation_scan"] == 1 and launches["merkle_fold"] > 0, launches
assert launches["sponge_rows"] == 1 and launches["sponge_rows_grouped"] == 1, launches
prover = cs.start_zoo_prover()
zoo_launches = cs.zoo_path(lib, cs.zoo_fixture(prover))
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
