"""The port's entry module and tools on the CPU at toy size:
plonky2_verifier_tpu_torch/graft_entry.py (the counterpart of
__graft_entry__.py) and tools/{distributed_dryrun, profile_verifier,
check_hash_kernels, bench_poseidon, lookup_device_check}. With --device cpu
the kernels' plain versions stand in, so each tool's code is walked here and
its checks are held against golden/; times taken here are the host's and are
only checked for presence. Tolerance: none (verdicts, counts, bit-exact
words)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from plonky2_verifier_tpu_torch import graft_entry, tracing
from plonky2_verifier_tpu_torch.tools import bench_poseidon, check_hash_kernels, lookup_device_check, probe_kernels as pk, profile_verifier
from torch_threads import child_env, one_torch_thread  # noqa: F401  (one_torch_thread: autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_graft_entry_accepts_all_four_lanes():
    fn, args = graft_entry.entry(device="cpu")
    with torch.no_grad():
        out = fn(*args)
    assert out["ok"].tolist() == [True] * 4
    assert {t.device.type for t in args[0].values()} == {"cpu"}


def test_graft_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_dryrun_multichip_defaults_to_a_card_a_rank():
    """Without device="cpu" every rank needs a card of its own: the parent
    raises before it proves or starts anything."""
    with pytest.raises(RuntimeError, match="need a CUDA card each"):
        graft_entry.dryrun_multichip(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="device must be None"):
        graft_entry.dryrun_multichip(2, device="cuda:0")


def test_dryrun_multichip_four_processes(capsys):
    """2 x 2 gloo processes, 4 heterogeneous lanes, lane 1 with a grinding
    fault and lane 2 with an opening fault: the line of
    __graft_entry__.dryrun_multichip."""
    graft_entry.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == "dryrun_multichip ok: mesh dp=2 qp=2, 4 heterogeneous lanes, 2 accepted, rejected lanes [1, 2] as expected"


def test_distributed_dryrun_two_processes_on_the_cpu(tmp_path):
    out = tmp_path / "report.json"
    cmd = [sys.executable, "-m", "plonky2_verifier_tpu_torch.tools.distributed_dryrun", "--nproc", "2", "--device", "cpu", "--out", str(out)]
    env = child_env()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stdout + res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == json.loads(out.read_text())
    assert report["ok"] and report["mesh"] == {"dp": 1, "qp": 2} and "gloo" in report["transport"]
    assert [p["process"] for p in report["processes"]] == [0, 1]
    for p in report["processes"]:
        assert p["ok"] and p["backend"] == "gloo" and p["device"] == "cpu"
        assert p["n_valid"] == p["batch"] - 1 == 1 and p["rejected_lanes"] == [1]


def test_distributed_dryrun_needs_a_card_of_its_own_for_every_rank():
    """Without --device cpu and --share-card rank r takes card r under NCCL;
    where there are fewer cards than ranks the tool raises before it starts
    one (no rank carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cmd = [sys.executable, "-m", "plonky2_verifier_tpu_torch.tools.distributed_dryrun", "--nproc", "2"]
    env = child_env()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "2 ranks need a CUDA card each and this host has 0" in res.stderr


def test_profile_verifier_stage_times_add_up(capsys):
    assert profile_verifier.main(["--model", "fibonacci6", "--batch", "2", "--device", "cpu"]) == 0
    res = _last_json(capsys)
    assert res["device"].startswith("cpu") and res["device_profile"] is None and "kernel_library_s" not in res
    stages = res["stages_ms"]
    want = ["pi hash", "transcript", "powers and inverses", "plonk: L0 and partial products", "plonk: selectors and gate program", "plonk: lookup argument",
            "plonk: alpha combination and quotient", "fri: proof of work and reduced openings", "fri: leaf hashes",
            "fri: initial Merkle walks", "fri: combineInitial", "fri: final polynomial"]
    assert list(stages) == want  # the 6-query fibonacci template has no fold step
    assert all(ms >= 0 for ms in stages.values())
    assert 0.95 * res["staged_call_ms"] <= sum(stages.values()) <= res["staged_call_ms"]
    spans = res["spans_ms"]  # the tracer's stage spans, each holding its stages
    assert list(spans) == ["challenges", "plonk_checks", "fri_checks"]
    assert sum(stages.values()) <= sum(spans.values()) <= res["staged_call_ms"]
    assert sum(stages[s] for s in want[:3]) <= spans["challenges"] and sum(stages[s] for s in want[3:7]) <= spans["plonk_checks"]
    assert res["syncs"] == {}  # the CPU never synchronises
    assert res["counts"] == {}  # fibonacci has no lookup table
    assert all(res[k] > 0 for k in ("construct_s", "first_call_s", "warm_call_s"))


def test_profile_verifier_puts_a_moment_in_the_innermost_span_open():
    """device_profile's merge of the profiler's events with the tracer's
    spans: a time goes to the innermost span open at it, nested or
    abutting, and to none outside them; a span without times on a clock is
    left out there."""
    raw = [{"name": "forward", "parent": None, "host_ns": [0, 100], "device_ns": [0, 100]},
           {"name": "challenges", "parent": 0, "host_ns": [0, 30], "device_ns": [0, 30]},
           {"name": "pi hash", "parent": 1, "host_ns": [0, 10], "device_ns": [0, 10]},
           {"name": "transcript", "parent": 1, "host_ns": [10, 30], "device_ns": [10, 30]},
           {"name": "plonk_checks", "parent": 0, "host_ns": [40, 90], "device_ns": [40, 90]},
           {"name": "stream.ingest", "parent": None, "host_ns": [200, 300], "device_ns": None}]
    points, labels = profile_verifier.innermost(raw, "host_ns")
    at = {t: profile_verifier.label_at(points, labels, t) for t in (-1, 0, 9, 10, 29, 30, 35, 40, 95, 100, 250, 300)}
    assert at == {-1: "(no span)", 0: "pi hash", 9: "pi hash", 10: "transcript", 29: "transcript", 30: "forward", 35: "forward",
                  40: "plonk_checks", 95: "forward", 100: "(no span)", 250: "stream.ingest", 300: "(no span)"}
    points, labels = profile_verifier.innermost(raw, "device_ns")
    assert profile_verifier.label_at(points, labels, 250) == "(no span)"


def test_profile_verifier_names_each_fold_step():
    """A template with a fold step: its Merkle walk is a stage of its own,
    every step's coset fold one stage (one kernel launch on the card), and
    tracing is off again."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.ops import field as tf
    from plonky2_verifier_tpu_torch.prover.prove import prove
    from plonky2_verifier_tpu_torch.tools import shape_circuits as sc
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    fx = sc.grid_fixture(*sc.GRID[0])
    tpl = CircuitTemplate(fx.common)
    assert tpl.steps
    v = TorchVerifier(tpl, device="cpu")
    inv_grouped = tf.inv_grouped
    res = profile_verifier.stage_times(v, v.prepare(flatten_proofs(tpl, [prove(fx)] * 2)))
    for s in range(len(tpl.steps)):
        assert f"fri: step {s} Merkle walk and opened slot" in res["stages_ms"]
    assert "fri: coset folds" in res["stages_ms"]
    assert not tracing._on and tf.inv_grouped is inv_grouped


def test_fold_work_counts_the_fft_form_and_the_kernels_butterflies():
    """probe_kernels.fold_work at a fibonacci forward's folds (two steps of
    arity 16 over (1024, 28)): the least work in the FFT form (the bound
    the kernel's share is taken against), 32 butterflies of 4 adds, 17 of
    them with 2 products by a twiddle (the 15 by a twiddle 1 need none),
    and the Horner chain a (b, q); the kernel's count the same and an add
    a word for the canonicalisation, so never below the least."""

    lanes, arity = 1024 * 28, 16
    evals = [torch.empty((1024, 28, arity, 2), dtype=torch.int64)] * 2
    idfts = [torch.empty((arity, arity), dtype=torch.int64)] * 2
    least, n_bytes, what, kernel = pk.fold_work(evals, [None] * 2, [None] * 2, [None] * 2, idfts)
    chain = arity * (4 * pk.PRODUCT + 4 * pk.ADD) + 4 * pk.PRODUCT
    assert least == 2 * lanes * (32 * 4 * pk.ADD + 17 * 2 * pk.PRODUCT + chain) == 137_625_600
    assert kernel == least + 2 * lanes * 2 * arity * pk.ADD == 144_965_632
    assert n_bytes == 8 * (2 * (lanes * (2 * arity + 3) + 2 * 1024 + arity * arity)) and f"the kernel's {kernel} instructions" in what


def test_print_sass_sums_the_pieces_of_a_permutation_and_a_compression(capsys, monkeypatch):
    """probe_kernels.print_sass on stand-in piece counts (csrc/permutation.cu's
    count kernels need nvcc): a permutation is pieces 1 + 7 x 2 + 21 x 3 +
    4 + 5, a compression 7 + 7 x 2 + 21 x 3 + 4 + 6; each piece's count
    after them."""
    from plonky2_verifier_tpu_torch import kernels

    pieces = {k: {"IMAD.WIDE": 10 * k, "IADD3": k} for k in range(1, 8)}
    monkeypatch.setattr(kernels, "sass_pieces", lambda: pieces)
    pk.print_sass()
    out = capsys.readouterr().out.splitlines()
    perm = 11 * (1 + 7 * 2 + 21 * 3 + 4 + 5)
    compression = 11 * (7 + 7 * 2 + 21 * 3 + 4 + 6)
    assert out[0].startswith(f"sass: {perm} instructions in one thread-form permutation (W = 19180), {compression} in a 2-to-1 compression: IMAD.WIDE")
    assert out[1] == "sass pieces: " + ", ".join(f"{k} {11 * k}" for k in range(1, 8))


def test_gate_filter_work_at_the_zoo_benchmark_shape():
    """probe_kernels.gate_filter_work on the gate-zoo benchmark template's rows
    at 16,384 lanes (13 live gates of 123 constraints, 60 live factors in
    rows of 6 slots): a term an emul and 2 adds, a factor a subtraction and
    an emul past a gate's first; bound by the operations, 0.155 ms at the
    H100's int32 rate, beside 0.135 ms for the bytes."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
    from plonky2_verifier_tpu_torch.ops import field as tf
    from plonky2_verifier_tpu_torch.types import load_common
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    v = TorchVerifier(CircuitTemplate(load_common(os.path.join(ROOT, "benchmark", "data", "gate-zoo-lookup-d12", "common.json"))), device="cpu")
    B, L, n_gc = 16384, 13, 123
    meta = lambda w: tf.GExt(torch.empty((B, w), dtype=torch.int64, device="meta"), torch.empty((B, w), dtype=torch.int64, device="meta"))
    least, n_bytes, what = pk.gate_filter_work(meta(4), meta(L * n_gc), v._filter_cols, v._filter_consts, v._filter_mask, n_gc)
    assert v._filter_cols.shape[0] == L and int(v._filter_mask.sum()) == 60 and v._filter_consts.shape[1] == 6
    assert least == B * (L * n_gc * (pk.EMUL + 2 * pk.ADD) + 60 * 2 * pk.ADD + (60 - L) * pk.EMUL) == 2_590_638_080
    assert n_bytes == 8 * (2 * B * 4 + 2 * B * L * n_gc + 2 * B * n_gc + L + L * 6) + L * 6
    ms, by = pk.field_bound_ms(least, n_bytes, 132 * pk.INT32_LANES_PER_SM * 1.98e9)
    assert by == "operations" and 0.154 < ms < 0.156 and 0.134 < n_bytes / pk.HBM_BYTES_PER_S * 1e3 < 0.136
    assert "13 live gates of 123 constraints" in what and "16 lanes a block" in what


@pytest.mark.parametrize("routed,n_polys,maxdeg,rows,lanes", [(80, 7, 8, 26, (2, 4, 4)), (6, 2, 4, 2, (1, 1, 1))], ids=["zoo", "one-lane"])
def test_lookup_work_counts_the_kernels_lanes(routed, n_polys, maxdeg, rows, lanes):
    """probe_kernels.lookup_work on the zoo's shape and on one where every part
    of the kernel takes one lane: the least work in the running pair's
    form (the bound the kernel's share is taken against); the kernel's
    count names its lanes (kernels.lookup_split) and adds the lanes'
    meetings and segments to it -- with one lane each, one Horner step a
    round (re_next's own, where the running chain starts from it)."""
    from plonky2_verifier_tpu_torch.ops import field as tf

    B, r = 3, 2
    ext = lambda w: tf.GExt(torch.zeros((B, w), dtype=torch.int64), torch.zeros((B, w), dtype=torch.int64))
    deltas = [tuple(torch.zeros(B, dtype=torch.int64) for _ in range(4))] * r
    coeffs, offsets = torch.zeros((rows, 2), dtype=torch.int64), torch.tensor([0, rows])
    least, n_bytes, what, kernel = pk.lookup_work(ext(5), ext(routed), ext(r * n_polys), ext(r * n_polys), deltas, coeffs, offsets, routed, maxdeg)
    n_sldc, num_lu, num_lut = n_polys - 1, routed // 2, routed // 3
    slot = 2 * pk.PRODUCT + 4 * pk.ADD
    per_round = (num_lu * (slot + 2 * pk.EMUL + 2 * pk.ADD) + num_lut * (slot + 3 * pk.EMUL + 2 * pk.ADD) + n_sldc * (4 * pk.EMUL + 6 * pk.ADD)
                 + num_lut * (4 * pk.PRODUCT + 4 * pk.ADD) + 2 * pk.ADD + pk.EMUL + rows * 2 * (pk.PRODUCT + pk.ADD)
                 + (pk.PRODUCT + 3 * pk.ADD + pk.EMUL) + 3 * pk.EMUL)
    assert least == B * r * per_round and n_bytes > 0
    assert f"lanes {lanes[0]} a chunk, {lanes[1]} the RE transition, {lanes[2]} a table" in what
    assert kernel > least if lanes != (1, 1, 1) else kernel == least + B * r * (4 * pk.PRODUCT + 4 * pk.ADD)


def test_check_hash_kernels_plain_versions_against_golden(capsys):
    assert check_hash_kernels.main(["--device", "cpu", "--random", "64", "--rows", "40"]) == 0
    res = _last_json(capsys)
    assert res["pass"] and "plain versions" in res["device"]
    for k in check_hash_kernels.KERNELS:
        assert res[f"{k}_bit_exact"] is True and res[f"{k}_words"] > 0


def test_check_hash_kernels_reports_a_word_that_differs(capsys, monkeypatch):
    from plonky2_verifier_tpu_torch.ops import poseidon as tp

    monkeypatch.setattr(check_hash_kernels.PlainLibrary, "permutation", lambda self, x, form="auto": tp.permutation_plain(x, self.consts) ^ 1)
    assert check_hash_kernels.main(["--device", "cpu", "--random", "8", "--rows", "8"]) == 1
    res = _last_json(capsys)
    assert res["pass"] is False and res["error"].startswith("permutation KAT")


@pytest.mark.parametrize("kernel", ["horner"])
def test_check_field_kernels_reports_a_word_that_differs(capsys, monkeypatch, kernel):
    """A stand-in that flips a bit of the field kernels' output is caught
    against the plain version."""
    plain = getattr(check_hash_kernels.PlainLibrary, kernel)
    flip = lambda out: out ^ 1 if isinstance(out, torch.Tensor) else (out[0] ^ 1, out[1])
    monkeypatch.setattr(check_hash_kernels.PlainLibrary, kernel, lambda self, *args: flip(plain(self, *args)))
    assert check_hash_kernels.main(["--device", "cpu", "--random", "8", "--rows", "8"]) == 1
    res = _last_json(capsys)
    assert res["pass"] is False and res["error"].startswith(kernel)



@pytest.mark.parametrize("kernel", ["gate_program"])
def test_check_field_kernels_catches_a_flipped_word(monkeypatch, kernel):
    """The gate program's checks catch a stand-in
    that flips a bit of the real part (run without the Poseidon checks
    before them)."""
    from plonky2_verifier_tpu_torch.ops import poseidon as tp
    from plonky2_verifier_tpu_torch.tools.check_field_kernels import check_field_kernels

    plain = getattr(check_hash_kernels.PlainLibrary, kernel)
    monkeypatch.setattr(check_hash_kernels.PlainLibrary, kernel, lambda self, *a, **kw: (lambda o: (o[0] ^ 1, o[1]))(plain(self, *a, **kw)))
    lib = check_hash_kernels.PlainLibrary(tp.PoseidonConstants("cpu"))
    with pytest.raises(AssertionError, match=f"^{kernel} "):
        check_field_kernels(lib, check_hash_kernels.new_checks(), "cpu", 8)

@pytest.mark.parametrize("kernel", ["inv_grouped", "pow_grouped"])
def test_check_field_kernels_catches_a_flipped_word_of_a_grouped_launch(monkeypatch, kernel):
    """The grouped inversion's and exponentiation's checks catch a stand-in
    that flips a bit of one output (the first fixed-generator segment's, for
    the exponentiation)."""
    from plonky2_verifier_tpu_torch.ops import poseidon as tp
    from plonky2_verifier_tpu_torch.tools.check_field_kernels import check_field_kernels

    plain = getattr(check_hash_kernels.PlainLibrary, kernel)

    def flipped(self, *a, **kw):
        out = plain(self, *a, **kw)
        if kernel == "inv_grouped":
            return out ^ 1
        gens, exts = out
        return ([gens[0] ^ 1] + gens[1:] if gens else gens), exts

    monkeypatch.setattr(check_hash_kernels.PlainLibrary, kernel, flipped)
    lib = check_hash_kernels.PlainLibrary(tp.PoseidonConstants("cpu"))
    with pytest.raises(AssertionError, match=f"^{kernel.split('_')[0]} grouped"):
        check_field_kernels(lib, check_hash_kernels.new_checks(), "cpu", 8)


def test_bench_poseidon_on_the_cpu_names_the_host_clock(capsys):
    assert bench_poseidon.main(["8", "32", "--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [l["batch"] for l in lines] == [8, 32]
    for l in lines:
        assert l["kernel_perms_per_sec"] is None and l["host_plain_perms_per_sec"] > 0 and "host clock" in l["device"]


def test_lookup_device_check_rejects_every_fault_lane_by_lane(capsys, tmp_path):
    out = tmp_path / "lookup.json"
    assert lookup_device_check.main(["--cases", "minimal", "--device", "cpu", "--out", str(out)]) == 0
    report = _last_json(capsys)
    assert report == json.loads(out.read_text())
    assert report["ok"] and report["device"] == "cpu"
    (case,) = report["cases"]
    assert case["case"] == "minimal_lookup" and case["accept"] and case["pass"]
    kinds = {label.split("[")[0] for label in case["rejects"]}
    assert kinds == {"lookup_zs", "lookup_zs_next", "lkp_sel", "lut_wire_mult"}
    assert all(case["rejects"].values()) and case["lanes"] == len(case["rejects"]) + 1


def test_lookup_faults_match_the_jax_tools():
    """The sweep is the one of tools/lookup_device_check.py, label by label."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
    from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof

    with open(os.path.join(ROOT, "tools", "lookup_device_check.py")) as f:
        source = f.read()
    tpl = CircuitTemplate(get_fixture_proof("lookup", **lookup_device_check.CASES["minimal"])[0])
    labels = [label for label, _, _ in lookup_device_check.lookup_faults(tpl)]
    for kind in {label.split("[")[0] for label in labels}:
        assert kind in source, kind
