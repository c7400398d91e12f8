"""Build, load and launch the port's CUDA kernels.

`build()` compiles each csrc/*.cu with nvcc for sm_90a into its own shared
library with a plain C interface, under csrc/_build/, all compiles started
together; a library is named by a sha256 of its source, the headers
(csrc/*.cuh) and the flags, so an edited source rebuilds. `load()` opens
them with ctypes once per process, uploads the Poseidon tables (the thread
form's `sparse_round_tables`, the split form's `folded_round_constants`;
the MDS matrix is compiled into csrc/poseidon.cuh) into each Poseidon
kernel's constant memory, and returns
the `KernelLibrary` whose methods launch the kernels: the three Poseidon
kernels (permutation.cu, sponge.cu, merkle.cu), the
three field kernels (field.cu: the extension Horner sum, and the inversion
and the exponentiations in the grouped form a verifier's forward launches
once each), the levelized gate program (gates.cu), every
FRI coset fold of a forward (fold.cu), and L0 with the partial products,
the lookup argument and the gate filter (plonk.cu).

Both raise on any failure (no CUDA device, no nvcc, a compile error, a
refused launch); nothing here falls back to the plain PyTorch versions.
Each launch method validates its tensors, allocates the output with
`torch.empty`, launches on the current stream without synchronising, checks
`cudaGetLastError()`, and adds one to its entry in `launches`; a Poseidon
launch also counts its permutations for the tracer (`count_permutations`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from . import tracing
from .golden.field import P
from .golden.poseidon import mds_matrix
from .golden.poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    FAST_PARTIAL_FIRST_ROUND_CONSTANT,
    FAST_PARTIAL_ROUND_CONSTANTS,
    FAST_PARTIAL_ROUND_INITIAL_MATRIX,
    FAST_PARTIAL_ROUND_VS,
    FAST_PARTIAL_ROUND_W_HATS,
    MDS_CIRC,
    MDS_DIAG,
)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
NVCC_FLAGS = ARCH_FLAGS + ["-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("permutation", "sponge", "merkle", "field", "gates", "fold", "plonk")
POSEIDON_SOURCES = ("permutation", "sponge", "merkle")  # take the Poseidon tables at load
# launch counters: the permutation and sponge kernels have two entry points each
COUNTERS = ("permutation", "permutation_scan", "sponge_rows", "sponge_rows_grouped", "merkle_fold", "horner", "inv_grouped",
            "pow_grouped", "gate_program", "coset_fold", "partial_products", "lookup_checks", "gate_filter")
FORMS = {"auto": 0, "thread": 1, "split": 2}
WIDTH, N_ROUNDS, FIRST_PARTIAL, FIRST_LAST_FULL = 12, 30, 4, 26
N_PARTIAL, SPARSE = FIRST_LAST_FULL - FIRST_PARTIAL, WIDTH - 1
SPLIT_MAX_STATES = 8192  # csrc/permutation.cu: up to this many states (or scan rows) "auto" takes the split form
# the tracer's work counters of the Poseidon kernels: permutations by round body
SPARSE_PERMUTATIONS = "poseidon sparse permutations"  # the thread form (csrc/poseidon.cuh permute)
DENSE_PERMUTATIONS = "poseidon dense permutations"  # the split form (permute_split)


def folded_round_constants():
    """The round constants as the kernels take them (csrc/poseidon.cuh):
    `pre` (12) is added to the input by both forms; the split form's dense
    rounds read the rest (permutation.cu), where `post[r]` (30, 12) is what round
    r's MDS rows start their sums from, i.e. the constants entering round
    r + 1. In a partial round only lane 0 passes the S-box, so the constants
    of lanes 1-11 commute with the MDS: they are carried forward, multiplied
    through, and arrive in post[25] before the last four full rounds."""
    rc = [list(ALL_ROUND_CONSTANTS[WIDTH * r : WIDTH * (r + 1)]) for r in range(N_ROUNDS)]
    mds = mds_matrix()
    post = [[0] * WIDTH for _ in range(N_ROUNDS)]
    for r in range(N_ROUNDS - 1):
        if not FIRST_PARTIAL <= r + 1 <= FIRST_LAST_FULL:
            post[r] = rc[r + 1]
    carried = [0] * WIDTH  # what lanes 1-11 still owe, entering partial round r
    for r in range(FIRST_PARTIAL, FIRST_LAST_FULL):
        e = [(d + c) % P for d, c in zip(carried, rc[r])]
        post[r - 1] = [e[0]] + [0] * (WIDTH - 1)
        carried = [sum(mds[i][j] * e[j] for j in range(1, WIDTH)) % P for i in range(WIDTH)]
    post[FIRST_LAST_FULL - 1] = [(d + c) % P for d, c in zip(carried, rc[FIRST_LAST_FULL])]
    return rc[0], post


def sparse_round_tables() -> dict:
    """The thread form's tables (csrc/poseidon.cuh), each a list of rows:
    - "full" (7, 12): what the MDS rows of full rounds 0-3 and 26-28 start
      from: the next round's constants, and for round 3 Plonky2's
      FAST_PARTIAL_FIRST_ROUND_CONSTANT (poseidon.rs partial_first_constant_layer);
    - "init" (11, 11): FAST_PARTIAL_ROUND_INITIAL_MATRIX transposed, row c
      the weights of lanes 1-11 in lane c + 1 (mds_partial_layer_init);
    - "w_hat", "vs" (22, 11): FAST_PARTIAL_ROUND_W_HATS and _VS as they are;
    - "row0" (22, 1): what sparse round r's row 0 starts from;
    - "tail" (1, 11): what lanes 1-11 still owe after the last sparse round.
    Plonky2 adds FAST_PARTIAL_ROUND_CONSTANTS[r] to lane 0 after round r's
    S-box. Its share of row 0 (m00 c, m00 = 25) goes into row0[r]; its share
    of lane j + 1 (c VS[r][j]) is carried in D, the kernel's lanes 1-11
    running behind their true values by D, so row0[r] also holds
    sum_j W_HATS[r][j] D_j. Round 26's constants arrive the same way: lane
    0's in row0[21], lanes 1-11's with the last D in "tail"."""
    rc = [list(ALL_ROUND_CONSTANTS[WIDTH * r : WIDTH * (r + 1)]) for r in range(N_ROUNDS)]
    m00 = MDS_CIRC[0] + MDS_DIAG[0]
    carried, row0 = [0] * SPARSE, []
    for r in range(N_PARTIAL):
        c = FAST_PARTIAL_ROUND_CONSTANTS[r]
        k = (m00 * c + sum(w * d for w, d in zip(FAST_PARTIAL_ROUND_W_HATS[r], carried))) % P
        row0.append([(k + rc[FIRST_LAST_FULL][0]) % P if r == N_PARTIAL - 1 else k])
        carried = [(d + c * v) % P for d, v in zip(carried, FAST_PARTIAL_ROUND_VS[r])]
    return {
        "full": rc[1:FIRST_PARTIAL] + [list(FAST_PARTIAL_FIRST_ROUND_CONSTANT)] + rc[FIRST_LAST_FULL + 1 :],
        "init": [[FAST_PARTIAL_ROUND_INITIAL_MATRIX[j][c] for j in range(SPARSE)] for c in range(SPARSE)],
        "w_hat": [list(row) for row in FAST_PARTIAL_ROUND_W_HATS],
        "vs": [list(row) for row in FAST_PARTIAL_ROUND_VS],
        "row0": row0,
        "tail": [[(d + c) % P for d, c in zip(carried, rc[FIRST_LAST_FULL][1:])]],
    }


# the tables' shapes, in the order csrc/poseidon.cuh's upload_constants reads them from one array
SPARSE_SHAPES = {"full": (2 * FIRST_PARTIAL - 1, WIDTH), "init": (SPARSE, SPARSE), "w_hat": (N_PARTIAL, SPARSE),
                 "vs": (N_PARTIAL, SPARSE), "row0": (N_PARTIAL, 1), "tail": (1, SPARSE)}


def sparse_table_words(tables) -> list:
    """The tables as one list of words, in the order upload_constants reads them."""
    return [c for name in SPARSE_SHAPES for row in tables[name] for c in row]


# The MDS sums of csrc/poseidon.cuh: a row's low accumulator starts from its
# whole folded constant and adds coefficients (sum ROW_SUM at most) times
# 32-bit halves; the join then adds (high accumulator >> 32) (2^32 - 1)
# without a carry. Both hold if every constant is below JOIN_LIMIT.
ROW_SUM = sum(MDS_CIRC) + max(MDS_DIAG)
JOIN_LIMIT = 2**64 - 2 * ROW_SUM * (2**32 - 1)


def check_round_body_bounds(post):
    """Raise unless the folded constants `post` and the MDS coefficients
    leave csrc/poseidon.cuh's accumulators the room they assume."""
    if ROW_SUM * 2**32 >= 2**41:
        raise ValueError("the kernels' MDS accumulators assume coefficients of sum < 2^9")
    if max(c for row in post for c in row) >= JOIN_LIMIT:
        raise ValueError("a folded round constant leaves the MDS join no room: it must be below JOIN_LIMIT")


def check_sparse_bounds(tables):
    """Raise unless the thread form's tables fit csrc/poseidon.cuh: the rows
    have the lengths the header reads; the full rounds' constants start
    dense MDS rows (below JOIN_LIMIT, as check_round_body_bounds); `add_tail`
    needs a canonical constant (below p); every other word is a multiplicand
    of `dot_term` or `mul_add_mod`, or the start of `dot_start`, whose ranges
    hold for any 64-bit word; row 0's own coefficient is dot_start's 32-bit
    multiplier."""
    for name, (rows, cols) in SPARSE_SHAPES.items():
        if len(tables[name]) != rows or any(len(row) != cols for row in tables[name]):
            raise ValueError(f"sparse table {name} is not ({rows}, {cols})")
        if any(not 0 <= c < 2**64 for row in tables[name] for c in row):
            raise ValueError(f"sparse table {name} holds a word outside [0, 2^64)")
    check_round_body_bounds(tables["full"])
    if max(tables["tail"][0]) >= P:
        raise ValueError("a tail constant is not canonical: add_rc needs it below p")
    if MDS_CIRC[0] + MDS_DIAG[0] >= 2**32:
        raise ValueError("row 0's own coefficient must fit dot_start's 32-bit multiplier")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def build() -> dict:
    """Compile the kernels whose sources changed, all at once; return the
    library path of each source. Prints nvcc's report (registers and spills
    per kernel) when it compiles."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; torch.cuda.is_available() is False")
    nvcc = _nvcc()
    header = b"".join(_read(os.path.join(CSRC, h)) for h in sorted(os.listdir(CSRC)) if h.endswith(".cuh"))
    libs, running = {}, []
    for name in SOURCES:
        src = os.path.join(CSRC, f"{name}.cu")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + header + _read(src))
        libs[name] = lib = os.path.join(BUILD_DIR, f"libp2v_{name}_{h.hexdigest()[:16]}.so")
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running.append((name, proc, tmp, lib))
    failed = []
    for name, proc, tmp, lib in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}\n{err}")
            continue
        print("\n".join(l for l in err.splitlines() if "registers" in l or "spill" in l or "Compiling" in l))
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


# csrc/permutation.cu's count_kernel pieces a thread-form permutation runs,
# and how often: the first constants and canonicalisation, the full rounds
# 0-3 and 26-28, the 22 sparse partial rounds, the 11 outputs of the initial
# matrix, the carried constants after them, round 29
PERMUTATION_PIECES = {1: 1, 2: 7, 3: 22, 4: 11, 8: 1, 5: 1}
# a 2-to-1 compression (the Merkle walk's permute<true, 4>): its own first
# constants and last round
COMPRESSION_PIECES = {7: 1, 2: 7, 3: 22, 4: 11, 8: 1, 6: 1}
N_PIECES = 9


def sass_pieces() -> dict:
    """The SASS instructions of each of csrc/permutation.cu's count_kernel
    pieces 1-8, by opcode (IMAD and IADD3 split by their first modifier:
    IMAD.WIDE multiplies, IMAD.MOV is a register move, IADD3.X an add with
    carry), piece 0's instructions taken out of each and no global load or
    store counted (they move a piece's words in and out, not the permutation's).
    permutation.cu is compiled with -DP2V_COUNT_ROUNDS. Needs nvcc and
    cuobjdump."""
    nvcc = _nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    os.makedirs(BUILD_DIR, exist_ok=True)
    cubin = os.path.join(BUILD_DIR, f"permutation_count.{os.getpid()}.cubin")
    cmd = [nvcc, *ARCH_FLAGS, "-DP2V_COUNT_ROUNDS", "-cubin", "-o", cubin, os.path.join(CSRC, "permutation.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    try:
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True, check=True).stdout
    finally:
        os.remove(cubin)
    pieces, piece = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"count_kernelILi(\d)E", line)
            piece = pieces.setdefault(int(m.group(1)), {}) if m else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*(?:\.(?:WIDE|MOV|SHL|IADD|X))?)", line)
        if piece is not None and m and m.group(1) != "NOP":
            piece[m.group(1)] = piece.get(m.group(1), 0) + 1
    if sorted(pieces) != list(range(N_PIECES)):
        raise RuntimeError(f"the counting kernels were not all found in the SASS: {sorted(pieces)}")
    base = pieces.pop(0)
    less_base = lambda ops: {op: ops.get(op, 0) - base.get(op, 0) for op in set(ops) | set(base)}
    return {k: {op: n for op, n in less_base(ops).items() if n and op not in ("LDG", "STG")} for k, ops in pieces.items()}


def sass_instruction_count(compression: bool = False, pieces=None) -> dict:
    """A cross-check of the kernels' distance from W (csrc/poseidon.cuh): the
    SASS instructions one thread-form permutation executes, by opcode, as
    the sum of its pieces (`sass_pieces`, or `pieces` as it returned them;
    `PERMUTATION_PIECES`, or with `compression` the Merkle walk's 2-to-1
    compression, `COMPRESSION_PIECES`). The rolled loops add a few
    instructions a round for their counters and branches, which this leaves
    out."""
    pieces = pieces or sass_pieces()
    counts = {}
    for k, times in (COMPRESSION_PIECES if compression else PERMUTATION_PIECES).items():
        for op, n in pieces[k].items():
            counts[op] = counts.get(op, 0) + times * n
    return {op: n for op, n in counts.items() if n}


def split_form(n: int, form: str) -> bool:
    """Whether csrc/permutation.cu runs n states (or scan rows) in the split
    form: asked for, or picked by "auto" up to SPLIT_MAX_STATES."""
    return form == "split" or (form == "auto" and n <= SPLIT_MAX_STATES)


def count_permutations(n: int, split: bool) -> None:
    """The tracer's counter of a Poseidon launch's permutations, by round
    body: the split form's dense rounds or the thread form's sparse ones.
    Host arithmetic only; nothing while the tracer is off."""
    tracing.count(DENSE_PERMUTATIONS if split else SPARSE_PERMUTATIONS, n)


class GateArgs(ctypes.Structure):
    """csrc/gates.cu's GateArgs, field for field."""

    _fields_ = [
        ("in_re", ctypes.c_void_p * 5), ("in_im", ctypes.c_void_p * 5),
        ("re_row", ctypes.c_int64 * 5), ("re_col", ctypes.c_int64 * 5),
        ("im_row", ctypes.c_int64 * 5), ("im_col", ctypes.c_int64 * 5),
        ("in_offset", ctypes.c_int32 * 5), ("in_width", ctypes.c_int32 * 5),
        ("lits", ctypes.c_void_p), ("loads", ctypes.c_void_p), ("step_off", ctypes.c_void_p),
        ("ops", ctypes.c_void_p), ("tail", ctypes.c_void_p),
        ("out_re", ctypes.c_void_p), ("out_im", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
        ("batch", ctypes.c_int64),
        ("n_slots", ctypes.c_int32), ("n_loads", ctypes.c_int32), ("n_lits", ctypes.c_int32), ("n_steps", ctypes.c_int32),
        ("n_ops", ctypes.c_int32), ("n_out", ctypes.c_int32), ("n_tail", ctypes.c_int32), ("lanes", ctypes.c_int32),
        ("staged", ctypes.c_int32),
    ]


class PowSegment(ctypes.Structure):
    """csrc/field.cu's PowSegment, field for field."""

    _fields_ = [
        ("out", ctypes.c_void_p), ("b_re", ctypes.c_void_p), ("b_im", ctypes.c_void_p), ("table", ctypes.c_void_p),
        ("e", ctypes.c_uint64), ("factor", ctypes.c_uint64), ("n", ctypes.c_int64), ("b_stride", ctypes.c_int64),
        ("ext", ctypes.c_int32), ("bits", ctypes.c_int32), ("shift", ctypes.c_int32), ("clear", ctypes.c_int32),
    ]


class ExtView(ctypes.Structure):
    """csrc/goldilocks.cuh's ExtView: an extension matrix, both parts at
    one stride pattern in words (a vector: one column)."""

    _fields_ = [("re", ctypes.c_void_p), ("im", ctypes.c_void_p), ("row", ctypes.c_int64), ("col", ctypes.c_int64)]


class FoldStep(ctypes.Structure):
    """csrc/fold.cu's FoldStep, field for field."""

    _fields_ = [
        ("evals", ctypes.c_void_p), ("off_inv", ctypes.c_void_p), ("beta_re", ctypes.c_void_p), ("beta_im", ctypes.c_void_p),
        ("idft", ctypes.c_void_p), ("out", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
        ("e_row", ctypes.c_int64), ("e_query", ctypes.c_int64), ("o_row", ctypes.c_int64), ("o_query", ctypes.c_int64),
        ("beta_stride", ctypes.c_int64), ("inv_arity", ctypes.c_uint64), ("arity_bits", ctypes.c_int32), ("unused", ctypes.c_int32),
    ]


class PartialProductArgs(ctypes.Structure):
    """csrc/plonk.cu's PartialProductArgs, field for field."""

    _fields_ = [(k, ExtView) for k in ("zeta_n", "l0_den_inv", "zeta", "zs", "zs_next", "pps", "wires", "sigmas")] + [
        ("betas", ctypes.c_void_p), ("gammas", ctypes.c_void_p), ("k_is", ctypes.c_void_p), ("out_re", ctypes.c_void_p),
        ("out_im", ctypes.c_void_p), ("batch", ctypes.c_int64),
        ("r", ctypes.c_int32), ("maxdeg", ctypes.c_int32), ("n_chunks", ctypes.c_int32), ("npp", ctypes.c_int32),
        ("lane_bits", ctypes.c_int32),
    ]


class LookupArgs(ctypes.Structure):
    """csrc/plonk.cu's LookupArgs, field for field."""

    _fields_ = [(k, ExtView) for k in ("sels", "wires", "zs", "zs_next")] + [
        ("deltas", ctypes.c_void_p), ("coeffs", ctypes.c_void_p), ("table_off", ctypes.c_void_p), ("out_re", ctypes.c_void_p),
        ("out_im", ctypes.c_void_p), ("batch", ctypes.c_int64),
        ("r", ctypes.c_int32), ("luts", ctypes.c_int32), ("n_polys", ctypes.c_int32), ("num_lu", ctypes.c_int32),
        ("num_lut", ctypes.c_int32), ("lu_deg", ctypes.c_int32), ("lut_deg", ctypes.c_int32),
        ("chunk_bits", ctypes.c_int32), ("re_bits", ctypes.c_int32), ("table_bits", ctypes.c_int32),
    ]


class GateFilterArgs(ctypes.Structure):
    """csrc/plonk.cu's GateFilterArgs, field for field."""

    _fields_ = [("sels", ExtView), ("cons", ExtView), ("cols", ctypes.c_void_p), ("consts", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("out_re", ctypes.c_void_p), ("out_im", ctypes.c_void_p), ("batch", ctypes.c_int64),
                ("live", ctypes.c_int32), ("n_gc", ctypes.c_int32), ("span", ctypes.c_int32), ("lanes", ctypes.c_int32)]


FOLD_MAX_STEPS = 32  # fold steps a launch of p2v_coset_fold (csrc/fold.cu): lde_bits <= 32, a step takes at least 1 bit
FOLD_SHARED_MAX_BITS = 5  # a fold step of arity up to 2^5 is staged in shared memory, a larger one in device scratch (csrc/fold.cu)
# the largest arity bits p2v_coset_fold takes: above every arity a Plonky2 FRI config gives (MinSize picks at
# most 2^4 by default; any step's arity divides the LDE of at most 2^32 points), and a step's (A, A) table of
# weights alone exceeds the card's memory from A = 2^17 on
FOLD_MAX_ARITY_BITS = 30
POW_MAX_SEGMENTS = 16  # segments a launch of p2v_pow_grouped (csrc/field.cu)
INV_GROUP = 8  # words a thread of p2v_inv_grouped: one Fermat chain a group (csrc/field.cu)
LOOKUP_SLOTS_A_LANE = 4  # a SLDC chunk's slots of each kind a lane at most (csrc/plonk.cu p2v_lookup_checks; probe_kernels --lookup-lanes)
LOOKUP_VALUES_A_SEGMENT = 8  # values of the RE transition's or a table's Horner sum a lane at most (the same probe)
GATE_FILTER_LANES = 16  # lanes a block of p2v_gate_filter (csrc/plonk.cu), fewer where their selector values outgrow 48 KB
GATE_FILTER_MAX_LIVE = 3072  # live gates p2v_gate_filter takes: one lane's 16-byte selector values in 48 KB of shared memory
GATE_FILTER_MAX_SPAN = 64  # factor slots a gate's row at most
HORNER_MAX_SEGMENTS = 32  # a row's segments share a warp (csrc/field.cu)
HORNER_MIN_CHAIN = 4  # values a segment at least
HORNER_THREADS_AN_SM = 256  # enough to hide a chain's latency (tools/probe_kernels.py --field)


@functools.lru_cache(maxsize=1024)
def horner_segments(rows: int, k: int, sms: int) -> int:
    """The segments a row that the Horner kernel splits a sum of `k`
    values over (csrc/field.cu): doubled from 1 while the rows' threads are
    fewer than HORNER_THREADS_AN_SM on each of `sms` SMs and every segment
    keeps at least HORNER_MIN_CHAIN values, up to HORNER_MAX_SEGMENTS. Each
    segment costs a tree level and point^S's squarings, so no more than
    the card needs to hide the chain's latency."""
    s = 1
    while 2 * s <= HORNER_MAX_SEGMENTS and 2 * s * HORNER_MIN_CHAIN <= k and s * rows < sms * HORNER_THREADS_AN_SM:
        s *= 2
    return s


def lookup_lanes(items: int, per_lane: int) -> int:
    """The fewest lanes, a power of two up to a warp's 32, that leave each at
    most `per_lane` of `items` (past 32 lanes, more a lane)."""
    lanes = 1
    while lanes < 32 and lanes * per_lane < items:
        lanes *= 2
    return lanes


def lookup_split(num_routed_wires: int, n_sldc: int, maxdeg: int, table_off, slots_a_lane: int = LOOKUP_SLOTS_A_LANE,
                 values_a_segment: int = LOOKUP_VALUES_A_SEGMENT):
    """The lanes of p2v_lookup_checks (csrc/plonk.cu): (a SLDC chunk's, the
    RE transition's, a table's), each at most `slots_a_lane` slots or
    `values_a_segment` values a lane. A chunk's lanes share its maxdeg - 1
    lookup and ceil(num_lut / n_sldc) table slots; the RE transition's the
    num_lut + 1 values of its Horner sum; a table's the rows of the longest
    table, from `table_off` (a list: the tables' first rows and the end)."""
    num_lut = num_routed_wires // 3
    rows = max((b - a for a, b in zip(table_off, table_off[1:])), default=0)
    return (lookup_lanes(max(maxdeg - 1, -(-num_lut // n_sldc)), slots_a_lane), lookup_lanes(num_lut + 1, values_a_segment),
            lookup_lanes(rows, values_a_segment))


PP_WIRES_A_LANE = 2  # the fastest of 1, 2, 4 and 8 wires a lane at the main path's shape (PERF.md §6)


def partial_products_lanes(maxdeg: int) -> int:
    """The lanes of a chunk in p2v_partial_products (csrc/plonk.cu):
    maxdeg / PP_WIRES_A_LANE rounded up to a power of two, at most a
    warp."""
    return min(1 << max(-(-maxdeg // PP_WIRES_A_LANE) - 1, 0).bit_length(), 32)


GATE_MAX_LANES = 32  # lanes a block at most (csrc/gates.cu)
GATE_THREADS_A_LANE = 64  # a block's threads: this many a lane, 64 to 1024; = gates_torch.STEP_OPS, so a step is one round


def _check_cuda(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _check_tensor(t: torch.Tensor, name: str, shape, dtype=torch.int64, contiguous: bool = True):
    """Raise unless t is a `dtype` tensor on the current CUDA device whose
    shape matches `shape` (None matches any size), contiguous unless the
    kernel is given its strides (`contiguous=False`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} must be on the current device cuda:{torch.cuda.current_device()}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {str(dtype).removeprefix('torch.')}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ext_view(pair, name: str, shape) -> ExtView:
    """An (re, im) pair of int64 CUDA tensors of `shape` (None: any size),
    1-D or 2-D, at any strides, the two parts at the same ones."""
    re, im = pair
    _check_tensor(re, f"{name} re", shape, contiguous=False)
    _check_tensor(im, f"{name} im", tuple(re.shape), contiguous=False)
    if im.stride() != re.stride():
        raise ValueError(f"{name} im has strides {im.stride()}, unlike the real part's {re.stride()}")
    row, col = (re.stride() + (0,))[:2]
    return ExtView(re.data_ptr(), im.data_ptr(), row, col)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class KernelLibrary:
    """The loaded kernels; `launches` counts launches per entry point."""

    def __init__(self, paths: dict):
        torch.cuda.init()
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        signatures = {
            "permutation": {
                "p2v_permutation": [vp, vp, i64, i32, vp],
                "p2v_permutation_scan": [vp, vp, vp, vp, i64, i64, i32, i32, vp],
            },
            "sponge": {
                "p2v_sponge_rows": [vp, vp, i64, i32, vp, vp],
                "p2v_sponge_rows_grouped": [vp, vp, vp, vp, i32, vp, vp, vp],
                "p2v_sponge_max_segments": [],
            },
            "merkle": {"p2v_merkle_fold": [vp, vp, vp, vp, i64, i32, vp]},
            "field": {
                "p2v_horner": [vp, vp, vp, vp, vp, vp, i64, i64, i64, i64, i64, i64, i64, i32, vp],
                "p2v_inv_grouped": [vp, vp, i64, vp],
                "p2v_pow_grouped": [vp, i32, vp, i64, i64, vp],
            },
            "gates": {"p2v_gate_program": [vp, i32, i32, vp], "p2v_gate_smem_limit": []},
            "fold": {"p2v_coset_fold": [vp, i32, i64, i64, vp]},
            "plonk": {"p2v_partial_products": [vp, vp], "p2v_lookup_checks": [vp, vp], "p2v_gate_filter": [vp, vp]},
        }
        pre, post = folded_round_constants()
        check_round_body_bounds(post)
        tables = sparse_round_tables()
        check_sparse_bounds(tables)
        pre, post = np.array(pre, dtype=np.uint64), np.array(post, dtype=np.uint64)
        sparse = np.array(sparse_table_words(tables), dtype=np.uint64)
        self._fn = {}
        self._libs = []
        for source, fns in signatures.items():
            lib = ctypes.CDLL(paths[source])
            self._libs.append(lib)
            # the split form's table goes to the permutation kernels alone
            init_args = (pre, post, sparse) if source == "permutation" else (pre, sparse)
            if source in POSEIDON_SOURCES:
                fns = dict(fns, **{f"p2v_{source}_init": [vp] * len(init_args)})
            for name, argtypes in fns.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self._fn[name] = fn
            if source in POSEIDON_SOURCES:
                err = self._fn[f"p2v_{source}_init"](*(a.ctypes.data for a in init_args))
                _check_cuda(err, f"p2v_{source}_init")
        self.max_segments = self._fn["p2v_sponge_max_segments"]()
        self.gate_smem_limit = self._fn["p2v_gate_smem_limit"]()  # bytes of shared memory a block may take
        if self.gate_smem_limit <= 0:
            raise RuntimeError("p2v_gate_smem_limit: the device's shared-memory limit could not be read")
        self.sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
        self.launches = dict.fromkeys(COUNTERS, 0)

    def reset_launches(self):
        self.launches = dict.fromkeys(COUNTERS, 0)

    def permutation(self, state: torch.Tensor, form: str = "auto") -> torch.Tensor:
        """states (n, 12) -> permuted states (n, 12). `form` picks the kernel:
        "thread" (a state per thread), "split" (a state per half-warp) or
        "auto" (by n, as csrc/permutation.cu says)."""
        _check_tensor(state, "state", (None, 12))
        out = torch.empty_like(state)
        n = state.shape[0]
        if n:
            err = self._fn["p2v_permutation"](state.data_ptr(), out.data_ptr(), n, FORMS[form], _stream())
            _check_cuda(err, "permutation")
            self.launches["permutation"] += 1
            count_permutations(n, split_form(n, form))
        return out

    def permutation_scan(
        self, data: torch.Tensor, ov_idx: torch.Tensor, ov_mask: torch.Tensor, form: str = "auto"
    ) -> torch.Tensor:
        """The transcript scan in one launch: data (B, n_data), the static
        schedule ov_idx (n_perms, 12) int64 and ov_mask (n_perms, 12) bool
        -> states (n_perms, B, 12). From a zero state, step i overwrites the
        masked lanes with data[:, ov_idx[i]], permutes, and records the state."""
        _check_tensor(data, "data", (None, None))
        n_perms = ov_idx.shape[0]
        _check_tensor(ov_idx, "ov_idx", (None, 12))
        _check_tensor(ov_mask, "ov_mask", (n_perms, 12), torch.bool)
        batch, n_data = data.shape
        states = torch.empty((n_perms, batch, 12), dtype=torch.int64, device=data.device)
        if batch and n_perms:
            err = self._fn["p2v_permutation_scan"](
                data.data_ptr(), ov_idx.data_ptr(), ov_mask.data_ptr(), states.data_ptr(),
                batch, n_data, n_perms, FORMS[form], _stream(),
            )
            _check_cuda(err, "permutation_scan")
            self.launches["permutation_scan"] += 1
            count_permutations(batch * n_perms, split_form(batch, form))
        return states

    def sponge_rows(self, rows: torch.Tensor, width: int) -> torch.Tensor:
        """rows (n, width) -> digests (n, 4)."""
        _check_tensor(rows, "rows", (None, width))
        n = rows.shape[0]
        out = torch.empty((n, 4), dtype=torch.int64, device=rows.device)
        if n:
            counter = torch.empty(1, dtype=torch.int32, device=rows.device)  # the blocks draw their rows from it
            err = self._fn["p2v_sponge_rows"](rows.data_ptr(), out.data_ptr(), n, width, counter.data_ptr(), _stream())
            _check_cuda(err, "sponge_rows")
            self.launches["sponge_rows"] += 1
            count_permutations(n * -(-width // 8), False)
        return out

    def sponge_rows_grouped(self, rows_list) -> list:
        """Several row matrices, each (n_k, width_k), hashed together:
        returns their digests (n_k, 4) in the order given. One launch takes
        `max_segments` matrices, longest rows first; a longer list takes
        several launches."""
        for k, rows in enumerate(rows_list):
            _check_tensor(rows, f"rows[{k}]", (None, None))
        counts = [rows.shape[0] for rows in rows_list]
        starts = [sum(counts[:k]) for k in range(len(counts))]
        device = torch.device("cuda", torch.cuda.current_device())
        out = torch.empty((sum(counts), 4), dtype=torch.int64, device=device)
        order = sorted((k for k in range(len(rows_list)) if counts[k]), key=lambda k: -rows_list[k].shape[1])
        for at in range(0, len(order), self.max_segments):
            seg = order[at : at + self.max_segments]
            args = [
                (ctypes.c_void_p * len(seg))(*(rows_list[k].data_ptr() for k in seg)),
                (ctypes.c_int64 * len(seg))(*(counts[k] for k in seg)),
                (ctypes.c_int * len(seg))(*(rows_list[k].shape[1] for k in seg)),
                (ctypes.c_int64 * len(seg))(*(starts[k] for k in seg)),
                len(seg),
                out.data_ptr(),
            ]
            counter = torch.empty(1, dtype=torch.int32, device=device)  # the blocks draw their rows from it
            err = self._fn["p2v_sponge_rows_grouped"](*args, counter.data_ptr(), _stream())
            _check_cuda(err, "sponge_rows_grouped")
            self.launches["sponge_rows_grouped"] += 1
            count_permutations(sum(counts[k] * -(-rows_list[k].shape[1] // 8) for k in seg), False)
        return [out[s : s + n] for s, n in zip(starts, counts)]

    def merkle_fold(self, digest: torch.Tensor, index: torch.Tensor, sibs: torch.Tensor) -> torch.Tensor:
        """digest (n, 4), index (n,), sibs (n, L, 4) -> roots (n, 4)."""
        _check_tensor(digest, "digest", (None, 4))
        n = digest.shape[0]
        _check_tensor(index, "index", (n,))
        _check_tensor(sibs, "sibs", (n, None, 4))
        out = torch.empty_like(digest)
        if n:
            err = self._fn["p2v_merkle_fold"](
                digest.data_ptr(), index.data_ptr(), sibs.data_ptr(), out.data_ptr(), n, sibs.shape[1], _stream()
            )
            _check_cuda(err, "merkle_fold")
            self.launches["merkle_fold"] += 1
            count_permutations(n * sibs.shape[1], False)
        return out

    def horner(self, v_re, v_im, p_re, p_im, v_rep: int = 1, p_rep: int = 1):
        """The extension Horner sum: out[n] = sum_k p[n // p_rep]^k
        v[n // v_rep, k] for n < rows of v x v_rep (= rows of p x p_rep), as
        verifier_torch.horner_ext_plain computes it. v_re and v_im are
        (rows, K) at any strides, the same for both (v_im None: base-field
        values); p_re and p_im (rows,) at any stride (p_im None: a
        base-field point). A row is split into horner_segments(rows, K)
        segments. Returns (out_re, out_im), each (n,)."""
        _check_tensor(v_re, "v_re", (None, None), contiguous=False)
        _check_tensor(p_re, "p_re", (None,), contiguous=False)
        n = v_re.shape[0] * v_rep
        if v_rep < 1 or p_rep < 1 or p_re.shape[0] * p_rep != n:
            raise ValueError(f"rows: values {v_re.shape[0]} x {v_rep} and point {p_re.shape[0]} x {p_rep} differ")
        for t, name, like in ((v_im, "v_im", v_re), (p_im, "p_im", p_re)):
            if t is not None:
                _check_tensor(t, name, (None,) * like.dim(), contiguous=False)
                if t.shape != like.shape or t.stride() != like.stride():
                    raise ValueError(f"{name} has shape {tuple(t.shape)} and strides {t.stride()}, "
                                     f"unlike the real part's {tuple(like.shape)} and {like.stride()}")
        k = v_re.shape[1]
        segments = horner_segments(n, k, self.sms)
        out = torch.empty((2, n), dtype=torch.int64, device=v_re.device)
        if n:
            ptr = lambda t: None if t is None else t.data_ptr()
            err = self._fn["p2v_horner"](
                v_re.data_ptr(), ptr(v_im), p_re.data_ptr(), ptr(p_im), out[0].data_ptr(), out[1].data_ptr(),
                n, k, v_re.stride(0), v_re.stride(1), v_rep, p_re.stride(0), p_rep, segments.bit_length() - 1, _stream(),
            )
            _check_cuda(err, "horner")
            self.launches["horner"] += 1
        return out[0], out[1]

    def inv_grouped(self, a: torch.Tensor) -> torch.Tensor:
        """a^(p - 2) elementwise, inv(0) = 0, by the batch trick: a thread
        a group of INV_GROUP words (word i in group i mod ceil(n / INV_GROUP)),
        one Fermat chain a group (csrc/field.cu). a contiguous, any shape;
        the bits of inv_plain."""
        _check_tensor(a, "a", (None,) * a.dim())
        out = torch.empty_like(a)
        if a.numel():
            err = self._fn["p2v_inv_grouped"](a.data_ptr(), out.data_ptr(), a.numel(), _stream())
            _check_cuda(err, "inv_grouped")
            self.launches["inv_grouped"] += 1
        return out

    def pow_grouped(self, idx, gens, exts):
        """Every power of one forward in one launch (csrc/field.cu
        p2v_pow_grouped; more than POW_MAX_SEGMENTS segments take several).
        `idx` (rows, q) int64, the query indices at any row stride (None where
        `gens` is empty). `gens`: (table, shift, clear, factor) a segment, the
        table the (bits,) int64 words g^(2^k), contiguous: element (r, c)
        gives factor * g^e with e the bit reversal over `bits` bits of
        ((idx[r, c] >> shift) >> clear << clear). `exts`: (re, im, e) a
        segment, the base's two parts (rows,) at one stride and a host
        exponent 2 <= e < 2^64: base^e. Returns ([(rows, q) a gen segment],
        [(re, im), each (rows,), an ext segment]), views of one allocation."""
        n_idx, idx_row, q = 0, 0, 0
        if gens:
            _check_tensor(idx, "idx", (None, None), contiguous=False)
            if idx.shape[1] > 1 and idx.stride(1) != 1:
                raise ValueError(f"idx must have column stride 1, got strides {idx.stride()}")
            n_idx, idx_row, q = idx.numel(), idx.stride(0), idx.shape[1]
        for k, (table, shift, clear, factor) in enumerate(gens):
            bits = table.shape[0] if table.dim() == 1 else -1
            _check_tensor(table, f"gens[{k}] table", (bits,))
            if not (0 <= bits <= 64 and 0 <= shift and 0 <= clear and shift + clear < 64 and 0 <= factor < P):
                raise ValueError(f"gens[{k}]: {bits} bits, shift {shift}, clear {clear}, factor {factor}")
        for k, (re, im, e) in enumerate(exts):
            _check_tensor(re, f"exts[{k}] re", (None,), contiguous=False)
            _check_tensor(im, f"exts[{k}] im", (re.shape[0],), contiguous=False)
            if im.stride() != re.stride():
                raise ValueError(f"exts[{k}] im has strides {im.stride()}, unlike the real part's {re.stride()}")
            if not 2 <= e < 2**64:  # e = 0 and 1: ops/field.pow_grouped answers them, with no launch
                raise ValueError(f"exts[{k}]: exponent {e}, a host exponent is a u64 of at least 2")
        n_gen = len(gens) * n_idx
        out = torch.empty(n_gen + 2 * sum(re.shape[0] for re, _, _ in exts), dtype=torch.int64,
                          device=torch.device("cuda", torch.cuda.current_device()))
        base = out.data_ptr()
        segs = [PowSegment(base + 8 * k * n_idx, None, None, table.data_ptr(), 0, factor, n_idx, 0, 0, table.shape[0], shift, clear)
                for k, (table, shift, clear, factor) in enumerate(gens)]
        ext_out, at = [], n_gen
        for re, im, e in exts:
            rows = re.shape[0]
            segs.append(PowSegment(base + 8 * at, re.data_ptr(), im.data_ptr(), None, e, 0, rows, re.stride(0), 1, 0, 0, 0))
            ext_out.append(out[at : at + 2 * rows].view(2, rows).unbind(0))
            at += 2 * rows
        live = [s for s in segs if s.n]
        for at in range(0, len(live), POW_MAX_SEGMENTS):
            chunk = live[at : at + POW_MAX_SEGMENTS]
            table = (PowSegment * len(chunk))(*chunk)  # held here until the call has copied it
            err = self._fn["p2v_pow_grouped"](ctypes.addressof(table), len(chunk), idx.data_ptr() if gens else None, idx_row, q, _stream())
            _check_cuda(err, "pow_grouped")
            self.launches["pow_grouped"] += 1
        gen_out = list(out[:n_gen].view(len(gens), *idx.shape).unbind(0)) if gens else []
        return gen_out, ext_out

    def gate_plan(self, batch: int, packed, form: str = "auto") -> dict:
        """How the gate program runs a batch: `lanes` a block (a power of two
        up to GATE_MAX_LANES: the most that leave a block for every SM and
        fit, with the program staged beside them, in a block's shared
        memory), the `form` (the tapes in shared memory where they fit),
        whether the program is `staged` into shared memory (where it fits
        beside the tapes), and `threads` a block (GATE_THREADS_A_LANE a
        lane). `form` as given where given."""
        tape = 16 * max(packed.n_slots, 1)
        program = 8 * packed.ops.shape[0] + 4 * packed.step_off.shape[0]
        room = self.gate_smem_limit - program if self.gate_smem_limit - program >= tape else self.gate_smem_limit
        most = max(1, min(GATE_MAX_LANES, -(-batch // self.sms), room // tape))
        lanes = 1 << (most.bit_length() - 1)
        if form == "auto":
            form = "shared" if tape * lanes <= self.gate_smem_limit else "global"
        tapes = tape * lanes if form == "shared" else 0
        threads = min(1024, max(64, GATE_THREADS_A_LANE * lanes))
        return {"form": form, "lanes": lanes, "staged": tapes + program <= self.gate_smem_limit, "threads": threads}

    def _gate_args(self, packed) -> GateArgs:
        """The packed program's fields of GateArgs, its tensors checked: once
        a PackedProgram (kept on it), since a call pays the host's time."""
        if packed.args is None:
            n_steps = packed.step_off.shape[0] - 1
            _check_tensor(packed.lits, "lits", (None,))
            for t, name, shape in ((packed.loads, "loads", (None, 2)), (packed.step_off, "step_off", (n_steps + 1,)),
                                   (packed.ops, "ops", (None, 2)), (packed.tail, "tail", (None, 2))):
                _check_tensor(t, name, shape, torch.int32)
            if packed.n_slots > 0xFFFF:
                raise ValueError(f"{packed.n_slots} tape slots, above the 65,535 a packed op can name")
            a = GateArgs()
            a.lits, a.loads, a.step_off = packed.lits.data_ptr(), packed.loads.data_ptr(), packed.step_off.data_ptr()
            a.ops, a.tail = packed.ops.data_ptr(), packed.tail.data_ptr()
            a.n_slots, a.n_loads, a.n_lits, a.n_steps = packed.n_slots, packed.loads.shape[0], packed.lits.shape[0], n_steps
            a.n_ops, a.n_out, a.n_tail = packed.ops.shape[0], packed.n_out, packed.tail.shape[0]
            packed.args = a
        return packed.args

    def gate_program(self, inputs, packed, form: str = "auto"):
        """The gate program for a batch of lanes (csrc/gates.cu). `inputs`:
        five (offset, re, im), the SEL, LKPSEL, CONST, WIRE and PI values,
        each part (B, w) at any strides (re and im None where w is 0), at
        program slots offset ... offset + w - 1; `packed` the program packed
        for its gather (compiler/gates_torch.PackedProgram), on the current
        device. Returns (out_re, out_im), each (B, n_out). `form`: "shared"
        (the tapes in shared memory), "global" (in scratch from torch.empty)
        or "auto" (shared where it fits). Lanes a block, a power of two up to
        32, and threads a block follow from the tape's size, the program's
        and the batch (gate_plan; the last block may hold fewer lanes)."""
        if len(inputs) != 5:
            raise ValueError("gate_program takes the five input kinds")
        template = self._gate_args(packed)
        device = packed.lits.device
        batch = next((re.shape[0] for _, re, _ in inputs if re is not None), None)
        if batch is None:
            raise ValueError("gate_program takes the five input kinds, at least one of them non-empty")
        a = GateArgs.from_buffer_copy(template)
        for k, (offset, re, im) in enumerate(inputs):
            a.in_offset[k] = offset
            if re is None:
                a.in_width[k] = 0
                continue
            if not (re.device == device == im.device and re.dtype == im.dtype == torch.int64 and re.dim() == 2
                    and re.shape[0] == batch and im.shape == re.shape):
                _check_tensor(re, "input re", (batch, None), contiguous=False)  # raises with the reason
                _check_tensor(im, "input im", tuple(re.shape), contiguous=False)
                raise ValueError(f"input {k} is not a pair of int64 (B, w) tensors on {device}")
            a.in_width[k] = re.shape[1]
            a.in_re[k], a.in_im[k] = re.data_ptr(), im.data_ptr()
            (a.re_row[k], a.re_col[k]), (a.im_row[k], a.im_col[k]) = re.stride(), im.stride()
        plan = self.gate_plan(batch, packed, form)
        form, lanes, threads = plan["form"], plan["lanes"], plan["threads"]
        tape = 16 * max(packed.n_slots, 1)
        if form not in ("shared", "global"):
            raise ValueError(f"form {form!r}: 'shared', 'global' or 'auto'")
        if form == "shared" and tape * lanes > self.gate_smem_limit:
            raise ValueError(f"{lanes} tapes of {packed.n_slots} slots need {tape * lanes} bytes of shared memory, above {self.gate_smem_limit}")
        out = torch.empty((2, batch, packed.n_out), dtype=torch.int64, device=device)
        if batch:
            blocks = -(-batch // lanes)
            scratch = torch.empty(blocks * 2 * packed.n_slots * lanes if form == "global" else 0, dtype=torch.int64, device=device)
            a.out_re, a.out_im, a.scratch = out[0].data_ptr(), out[1].data_ptr(), scratch.data_ptr()
            a.batch, a.lanes, a.staged = batch, lanes, plan["staged"]
            err = self._fn["p2v_gate_program"](ctypes.addressof(a), form == "shared", threads, _stream())
            _check_cuda(err, "gate_program")
            self.launches["gate_program"] += 1
        return out[0], out[1]

    def coset_fold(self, steps):
        """Every FRI step's coset fold in one launch (csrc/fold.cu), as
        verifier_torch.coset_fold_plain computes each. `steps`: (evals,
        off_inv, beta_re, beta_im, idft) a step, evals (B, Q, A, 2) with its
        (A, 2) values contiguous, off_inv (B, Q) at any strides, beta_re and
        beta_im (B,) at one stride, idft the (A, A) weights omega^(-jk),
        contiguous; every step over the same (B, Q). A step of arity above
        2^FOLD_SHARED_MAX_BITS stages its values in device scratch allocated
        here (2A B Q words). Returns (steps, 2, B, Q): a step's folded (re,
        im)."""
        if len(steps) > FOLD_MAX_STEPS:
            raise ValueError(f"{len(steps)} fold steps, above the {FOLD_MAX_STEPS} a launch takes")
        batch, queries = steps[0][1].shape if steps else (0, 0)
        device = torch.device("cuda", torch.cuda.current_device())
        out = torch.empty((len(steps), 2, batch, queries), dtype=torch.int64, device=device)
        table = (FoldStep * max(len(steps), 1))()
        scratch = []  # alive until the launch is enqueued; the allocator orders its reuse on this stream after it
        for k, (evals, off_inv, beta_re, beta_im, idft) in enumerate(steps):
            arity = idft.shape[0] if idft.dim() == 2 else -1
            if arity < 1 or arity & (arity - 1):
                raise ValueError(f"step {k}: idft has shape {tuple(idft.shape)}, not (A, A) with A a power of two")
            bits = arity.bit_length() - 1
            if bits > FOLD_MAX_ARITY_BITS:
                raise ValueError(f"step {k}: arity 2^{bits}, above the 2^{FOLD_MAX_ARITY_BITS} a launch takes")
            _check_tensor(idft, f"step {k} idft", (arity, arity))
            _check_tensor(evals, f"step {k} evals", (batch, queries, arity, 2), contiguous=False)
            if evals.numel() and evals.stride()[2:] != (2, 1):
                raise ValueError(f"step {k}: evals' (A, 2) values must be contiguous, got strides {evals.stride()}")
            _check_tensor(off_inv, f"step {k} off_inv", (batch, queries), contiguous=False)
            beta = _ext_view((beta_re, beta_im), f"step {k} beta", (batch,))
            if bits > FOLD_SHARED_MAX_BITS:
                scratch.append(torch.empty(2 * arity * batch * queries, dtype=torch.int64, device=device))
            table[k] = FoldStep(evals.data_ptr(), off_inv.data_ptr(), beta.re, beta.im, idft.data_ptr(), out[k].data_ptr(),
                                scratch[-1].data_ptr() if bits > FOLD_SHARED_MAX_BITS else None,
                                evals.stride(0), evals.stride(1), off_inv.stride(0), off_inv.stride(1), beta.row,
                                pow(arity, P - 2, P), bits, 0)
        if out.numel():
            err = self._fn["p2v_coset_fold"](ctypes.addressof(table), len(steps), batch, queries, _stream())
            _check_cuda(err, "coset_fold")
            self.launches["coset_fold"] += 1
        return out

    def partial_products(self, zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg: int):
        """L0(zeta)(z - 1) a round and the partial-product checks
        (csrc/plonk.cu), as verifier_torch.partial_products_plain computes
        them: every extension operand an (re, im) pair at any strides,
        zeta_n, l0_den_inv and zeta (B,), zs and zs_next (B, r), pps (B, r
        npp), wires and sigmas (B, ns) with ns = n_chunks maxdeg and npp =
        n_chunks - 1; betas and gammas (B, r) and k_is (ns,), contiguous.
        Returns (out_re, out_im), each (B, r + r n_chunks); a chunk takes
        partial_products_lanes(maxdeg) lanes."""
        z = _ext_view(zs, "zs", (None, None))
        batch, r = zs[0].shape
        ns = sigmas[0].shape[1] if sigmas[0].dim() == 2 else -1
        if maxdeg < 1 or ns < maxdeg or ns % maxdeg:
            raise ValueError(f"{ns} sigmas do not make chunks of {maxdeg}")
        n_chunks = ns // maxdeg
        a = PartialProductArgs()
        a.zs = z
        for name, pair, shape in (("zeta_n", zeta_n, (batch,)), ("l0_den_inv", l0_den_inv, (batch,)), ("zeta", zeta, (batch,)),
                                  ("zs_next", zs_next, (batch, r)), ("pps", pps, (batch, r * (n_chunks - 1))),
                                  ("wires", wires, (batch, ns)), ("sigmas", sigmas, (batch, ns))):
            setattr(a, name, _ext_view(pair, name, shape))
        _check_tensor(betas, "betas", (batch, r))
        _check_tensor(gammas, "gammas", (batch, r))
        _check_tensor(k_is, "k_is", (ns,))
        out = torch.empty((2, batch, r + r * n_chunks), dtype=torch.int64, device=betas.device)
        a.betas, a.gammas, a.k_is, a.out_re, a.out_im = betas.data_ptr(), gammas.data_ptr(), k_is.data_ptr(), out[0].data_ptr(), out[1].data_ptr()
        a.batch, a.r, a.maxdeg, a.n_chunks, a.npp = batch, r, maxdeg, n_chunks, n_chunks - 1
        a.lane_bits = partial_products_lanes(maxdeg).bit_length() - 1
        if batch and r:
            err = self._fn["p2v_partial_products"](ctypes.addressof(a), _stream())
            _check_cuda(err, "partial_products")
            self.launches["partial_products"] += 1
        return out[0], out[1]

    def lookup_checks(self, sels, wires, zs, zs_next, deltas, coeffs, table_off, num_routed_wires: int, maxdeg: int, lanes=None):
        """The lookup equations of every round (csrc/plonk.cu), as
        verifier_torch.lookup_checks_plain computes them: sels (B, 4 + luts),
        wires (B, num_wires), zs and zs_next (B, r n_polys), each an (re, im)
        pair at any strides; deltas (B, r, 4) contiguous, (a, b, alpha,
        delta) a round; coeffs (rows, 2) the padded tables one after the
        other and table_off (luts + 1,) their first rows, contiguous.
        lanes: (a chunk's, the RE transition's, a table's), powers of two up
        to 32, as lookup_split gives them for these tables; None reads
        table_off to the host for them (a caller with the tables' lengths
        on the host passes them). Returns (out_re, out_im), each (B, r (4 +
        luts + 2 n_sldc))."""
        _check_tensor(deltas, "deltas", (None, None, 4))
        batch, r = deltas.shape[:2]
        luts = table_off.shape[0] - 1 if table_off.dim() == 1 else -1
        if luts < 0:
            raise ValueError(f"table_off has shape {tuple(table_off.shape)}, expected (luts + 1,)")
        _check_tensor(table_off, "table_off", (luts + 1,))
        _check_tensor(coeffs, "coeffs", (None, 2))
        a = LookupArgs()
        a.zs = _ext_view(zs, "zs", (batch, None))
        n_polys = zs[0].shape[1] // r if r else 0
        if n_polys < 2 or zs[0].shape[1] != r * n_polys:
            raise ValueError(f"lookup_zs of {zs[0].shape[1]} columns is not {r} rounds of at least 2 polynomials")
        num_lu, num_lut = num_routed_wires // 2, num_routed_wires // 3
        a.zs_next = _ext_view(zs_next, "zs_next", (batch, r * n_polys))
        a.sels = _ext_view(sels, "sels", (batch, 4 + luts))
        a.wires = _ext_view(wires, "wires", (batch, None))
        if wires[0].shape[1] < max(2 * num_lu, 3 * num_lut):
            raise ValueError(f"{wires[0].shape[1]} wires, fewer than {num_routed_wires} routed ones")
        n_sldc = n_polys - 1
        if maxdeg < 2 or num_lu > n_sldc * (maxdeg - 1):
            raise ValueError(f"{num_lu} lookup slots do not fit {n_sldc} chunks of {maxdeg - 1}")
        out = torch.empty((2, batch, r * (4 + luts + 2 * n_sldc)), dtype=torch.int64, device=deltas.device)
        a.deltas, a.coeffs, a.table_off = deltas.data_ptr(), coeffs.data_ptr(), table_off.data_ptr()
        a.out_re, a.out_im, a.batch, a.r, a.luts, a.n_polys = out[0].data_ptr(), out[1].data_ptr(), batch, r, luts, n_polys
        a.num_lu, a.num_lut, a.lu_deg, a.lut_deg = num_lu, num_lut, maxdeg - 1, -(-num_lut // n_sldc)
        if num_lut < 1:
            raise ValueError(f"{num_routed_wires} routed wires make no table slot")
        lanes = lookup_split(num_routed_wires, n_sldc, maxdeg, table_off.tolist()) if lanes is None else tuple(lanes)
        if len(lanes) != 3 or any(x < 1 or x > 32 or x & (x - 1) for x in lanes):
            raise ValueError(f"lanes {lanes}: not three powers of two up to 32")
        a.chunk_bits, a.re_bits, a.table_bits = (x.bit_length() - 1 for x in lanes)
        if batch and r:
            err = self._fn["p2v_lookup_checks"](ctypes.addressof(a), _stream())
            _check_cuda(err, "lookup_checks")
            self.launches["lookup_checks"] += 1
        return out[0], out[1]


    def gate_filter(self, sels, cons, cols, consts, mask, n_gc: int):
        """The gate constraints filtered by their gates' selectors and summed
        (csrc/plonk.cu), as verifier_torch.gate_filter_plain computes them:
        sels (B, n_sel), the gate-selector columns, and cons (B, L n_gc), the
        L live gates' constraints one gate after the other, each an (re,
        im) pair at any strides; cols (L,), consts (L, span) and mask (L,
        span) bool, the live gates' selector columns, factor constants and
        factor slots, contiguous. Returns (out_re, out_im), each (B, n_gc);
        no launch where B or L is 0 (zeros)."""
        _check_tensor(cols, "cols", (None,))
        live = cols.shape[0]
        _check_tensor(consts, "consts", (live, None))
        span = consts.shape[1]
        _check_tensor(mask, "mask", (live, span), torch.bool)
        s = _ext_view(sels, "sels", (None, None))
        batch = sels[0].shape[0]
        c = _ext_view(cons, "cons", (batch, live * n_gc))
        if n_gc < 0 or live and (n_gc < 1 or live > GATE_FILTER_MAX_LIVE or not 1 <= span <= GATE_FILTER_MAX_SPAN):
            raise ValueError(f"{live} live gates of {n_gc} constraints and {span} factor slots: the kernel takes n_gc >= 1, "
                             f"at most {GATE_FILTER_MAX_LIVE} live gates and 1 to {GATE_FILTER_MAX_SPAN} slots")
        out = (torch.empty if live else torch.zeros)((2, batch, n_gc), dtype=torch.int64, device=cols.device)
        if batch and live:
            a = GateFilterArgs(s, c, cols.data_ptr(), consts.data_ptr(), mask.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), batch,
                               live, n_gc, span, min(GATE_FILTER_LANES, GATE_FILTER_MAX_LIVE // live))
            err = self._fn["p2v_gate_filter"](ctypes.addressof(a), _stream())
            _check_cuda(err, "gate_filter")
            self.launches["gate_filter"] += 1
        return out[0], out[1]


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernels once per process."""
    return KernelLibrary(build())
