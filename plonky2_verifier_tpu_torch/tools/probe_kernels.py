"""A one-minute probe of the kernels on the card, for development: their
times beside their bounds, without a proof to verify.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.probe_kernels [--field | --stages | --lookup-lanes]

With --field it builds, runs the whole check (step 2) and then only the
field probe: the Horner sum at the main path's shapes (batch 1024, 28
queries) and the gate program of the fibonacci and gate-zoo circuits at
1024 lanes, each as the library launches it (segments a row; lanes and
threads a block), beside its bound.

With --stages it builds and times the stage kernels -- the coset folds, L0
with the partial products, the lookup argument and the gate filter -- on
the arguments that one forward gives them at batch 1024 on random proof
words (the standard fibonacci template; the lookup argument the gate
zoo's, which fibonacci has none of), and prints their rows as one JSON line:
ms by events, device ms, bound and share. Each timed call is first held
bit-exact against its plain version. No check runs first.

With --stages it then counts the SASS instructions of a product, an add,
the extension ops and the once-reduced forms of the partial products
(csrc/probe_field_sass.cu, read with cuobjdump) and prints the fold's, the
lookup argument's and the partial products' own counts at W's reckoning
and at those weights beside their device time, as a share of the card's
int32 and issue rates.

With --lookup-lanes it builds and times the lookup kernel on the gate
zoo's call at batch 1024 (random proof words) on the lanes that
kernels.lookup_split gives at every pair of slots a lane and values a
segment in 1, 2, 4, 8 (the shipped pair: LOOKUP_SLOTS_A_LANE and
LOOKUP_VALUES_A_SEGMENT), passed to the wrapper, with the device ms; each
call held bit-exact against the plain version.

Without an option it
1. builds the kernels and prints nvcc's registers and spills;
2. runs tools/check_hash_kernels.py's check at a reduced random size (every kernel,
   form and entry point bit-exact against its plain version and golden/);
3. times the permutation in both forms over n = 64 ... 2^20 and the scan in
   both forms over B = 1 ... 16384 on a synthetic schedule of the standard
   shape (873 data words, 113 steps, 8 lanes overwritten a step), each
   beside its bound: where the forms cross says where the launcher's switch
   (csrc/permutation.cu SPLIT_MAX_STATES) should sit;
4. times the Merkle walk and the row sponge at the standard shape's sizes,
   then the grouped sponge launch over the six matrices of one verifier call
   (fibonacci and gate-zoo widths, batch 1024) beside the same six hashed one
   launch each;
5. runs the field probe (--field's);
6. builds csrc/probe_cycles.cu and prints the cycles one warp spends in one
   modular multiply, one S-box, one shuffle, and one permutation in each
   form (clock64 around 20 dependent repetitions);
7. prints the SASS instruction count of one permutation (print_sass).

Any failed check raises. Times are CUDA-event times of repeated launches.

The yardsticks live here too: W, the integer work of a permutation
(csrc/poseidon.cuh), over the card's int32 rate at its maximum SM clock,
beside the bytes over its memory rate (bound_ms, field_bound_ms), and the
least work of each field kernel's call (the `*_work` functions), which the
kernels' sources cite as their bounds.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .. import kernels
from .. import verifier_torch as vt
from ..ops import field as tf
from ..ops import poseidon as tp
from .bench_poseidon import _host_ms, device_ms, event_ms
from .check_hash_kernels import check_kernels, rand_words

BATCH = 1024
STANDARD = {"n_arith_rows": 4093, "num_query_rounds": 28, "proof_of_work_bits": 16}  # the standard fibonacci shape
ZOO = {"target_degree_bits": 12, "num_query_rounds": 28, "proof_of_work_bits": 16}  # the gate-zoo shape
# The yardstick (csrc/poseidon.cuh): W 32-bit integer instructions a
# permutation, over SMs x 64 int32 lanes x the maximum SM clock; bytes over
# the H100's 3.35 TB/s beside it.
W_INSTRUCTIONS = 19180
# int32 instructions of a Goldilocks product and add (W's reckoning), and of the
# extension ops built from them: an emul is 5 products and 2 adds
PRODUCT, ADD = 16, 4
EMUL = 5 * PRODUCT + 2 * ADD
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12

PERM_SIZES = [64, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 1 << 20]
SCAN_BATCHES = [1, 64, 1024, 4096, 16384]
N_DATA, N_PERMS = 873, 113  # the standard shape's transcript
MERKLE_SHAPES = [(114688, 11), (28672, 7), (28672, 3)]
SPONGE_SHAPES = [(1024, 3), (28672, 83), (28672, 135), (28672, 20), (28672, 16), (28672, 32)]
# the six row matrices one verifier call hashes at batch 1024, 28 queries
SPONGE_GROUPS = {
    "fibonacci": [(28672, 135), (28672, 83), (28672, 32), (28672, 32), (28672, 20), (28672, 16)],
    "gate zoo": [(28672, 135), (28672, 91), (28672, 34), (28672, 32), (28672, 32), (28672, 16)],
}


def device_phase():
    """Raises SystemExit without a card; prints nvidia-smi's name and power
    limit and the int32 rate the bounds take. Returns (that line, the rate
    in instructions/s)."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * INT32_LANES_PER_SM * float(clock) * 1e6
    print(f"bound: {sms} SMs x {INT32_LANES_PER_SM} int32 lanes x {clock} MHz (clocks.max.sm) = {rate:.4e} instructions/s; "
          f"W = {W_INSTRUCTIONS} a permutation -> {W_INSTRUCTIONS / rate * 1e9:.4f} ns a permutation")
    return smi, rate


def print_sass():
    """The SASS instructions of one thread-form permutation and of one 2-to-1
    compression (kernels.sass_instruction_count), by opcode, beside W, then
    each piece's count. Needs nvcc and cuobjdump."""
    pieces = kernels.sass_pieces()
    counts = kernels.sass_instruction_count(pieces=pieces)
    compression = sum(kernels.sass_instruction_count(compression=True, pieces=pieces).values())
    by_op = ", ".join(f"{k} {n}" for k, n in sorted(counts.items(), key=lambda kv: -kv[1]))
    print(f"sass: {sum(counts.values())} instructions in one thread-form permutation (W = {W_INSTRUCTIONS}), "
          f"{compression} in a 2-to-1 compression: {by_op}")
    print("sass pieces: " + ", ".join(f"{k} {sum(ops.values())}" for k, ops in sorted(pieces.items())))


def bound_ms(permutations: int, n_bytes: int, rate: float):
    """(bound ms, "operations" or "bytes"): the larger of the integer work
    over the card's int32 rate and the bytes over its memory rate."""
    return field_bound_ms(permutations * W_INSTRUCTIONS, n_bytes, rate)


def field_bound_ms(instructions: int, n_bytes: int, rate: float):
    """(bound ms, "operations" or "bytes") of a kernel: its int32
    instructions (16 a product, 4 an add, as W counts them) over the card's
    int32 rate, beside the bytes over its memory rate."""
    ops_ms = instructions / rate * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# int32 instructions a value of a Horner sum, by (base-field values, base-field
# point), the least that csrc/field.cu's steps need: with an extension point
# a step's product by q is 4 products (7 q.im formed once) and 2 adds, then
# 2 adds for the value; with base-field values two values a step,
# v + q v' + q^2 acc, 6 products and 5 adds for the two; with a base-field
# point 2 products and 2 adds a value, 1 and 1 where the values are
# base-field too (the sum stays in the base field)
HORNER_VALUE = {
    (False, False): 4 * PRODUCT + 4 * ADD,
    (True, False): (6 * PRODUCT + 5 * ADD) // 2,
    (False, True): 2 * PRODUCT + 2 * ADD,
    (True, True): PRODUCT + ADD,
}


def horner_work(args):
    """(int32 instructions, bytes) of one horner launch on `args`
    (verifier_torch.horner_rows): HORNER_VALUE a value of every row (the
    segments' tree and point^S's squarings not counted: the plain chain
    needs neither); each distinct value and point word is read once, each
    output written once."""
    v_re, v_im, p_re, p_im, v_rep, p_rep = args
    n, k = v_re.shape[0] * v_rep, v_re.shape[1]
    words = v_re.numel() * (1 if v_im is None else 2) + p_re.numel() * (1 if p_im is None else 2) + 2 * n
    return n * k * HORNER_VALUE[v_im is None, p_im is None], 8 * words


def gate_work(packed, inputs):
    """(int32 instructions, bytes) of one gate-program launch on the packed
    program (the ops its gather needs): an add is a reduction, a negation
    and an add on each part (3 adds; the kernel's product by the sign is
    one way to the same bits), a multiply an emul, every lane; each input
    word, literal and word of the program read once, each output word
    written once."""
    lanes = next(iter(inputs.values())).re.shape[0]
    instructions = lanes * (packed.n_adds * 6 * ADD + packed.n_muls * EMUL)
    words = sum(2 * x.re.numel() for x in inputs.values()) + packed.lits.numel() + 2 * lanes * packed.n_out
    program = 4 * sum(t.numel() for t in (packed.loads, packed.step_off, packed.ops, packed.tail))
    return instructions, 8 * words + program


def fold_work(evals, off_invs, betas, perms, idfts, *, product=PRODUCT, add=ADD):
    """(int32 instructions, bytes, description, the kernel's instructions)
    of one coset_fold launch, the least the function needs, counted in the
    FFT form: a (b, q) of a step of arity A takes A log2(A) / 2 butterflies
    (an extension add and subtract, 4 adds), all but the A - 1 whose
    twiddle is 1 with a base-field twiddle times an extension value (2
    products), the Horner chain in c = beta off_inv (4 products and 4 adds
    a value; c itself 2 products) and the scaling by 1/A (2 products); each
    opened value, offset inverse and beta word read once, the (A, A)
    weights once, each folded pair written once. The kernel (csrc/fold.cu)
    runs these and besides makes each opened word canonical (an add a
    word). `product` and `add`: the instructions a product and an add are
    counted at (W's reckoning unless given)."""
    least = kernel = n_words = 0
    for e, w in zip(evals, idfts):
        B, Q, arity = e.shape[:3]
        lanes, butterflies = B * Q, arity * (arity.bit_length() - 1) // 2
        chain = arity * (4 * product + 4 * add) + 4 * product
        least += lanes * (butterflies * 4 * add + (butterflies - arity + 1) * 2 * product + chain)
        kernel += lanes * 2 * arity * add
        n_words += lanes * (2 * arity + 3) + 2 * B + w.numel()
    kernel += least
    what = f"coset_fold: {len(evals)} steps of arity {[e.shape[2] for e in evals]} at {tuple(evals[0].shape[:2])}; the kernel's {kernel} instructions"
    return least, 8 * n_words, what, kernel


def partial_products_work(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg, *, weights=None):
    """(int32 instructions, bytes, description, the kernel's instructions)
    of one partial_products launch. The least the function needs: beta
    zeta a round (2 products); a wire's numerator term k_i times it (2) and
    3 adds, its denominator term an escale of sigma (2) and 3 adds, a round;
    a chunk's two products maxdeg - 1 emuls each, two emuls by the current
    values and a subtraction; L0 an emul a lane and one a round, with their
    subtractions; each opening and challenge word read once, each output
    written once. The kernel (csrc/plonk.cu; L lanes a chunk,
    kernels.partial_products_lanes) runs on every lane of a chunk's group,
    padding lanes too: beta zeta (2 products), ceil(maxdeg / L) wires'
    terms (four products, each added to its words and reduced once:
    goldilocks.cuh's mul_add), the chain of a lane's further wires (2 emuls
    a wire), log2 L tree levels of one emul and the last emul (L = 1: the
    two), a subtraction (2 subs); a thread a (b, round) L0's 2 emuls and 4
    subs. `weights`: the instructions of "mul", "mul_add" (a b + c),
    "mul_add2" (a b + c + d), "emul" (each part reduced once) and "sub" the
    kernel's ops are counted at, W's reckoning unless given (a product
    PRODUCT, an add ADD, an emul EMUL); the least is W's always."""
    B, r = zs.shape
    ns = sigmas.shape[1]
    n_chunks = ns // maxdeg
    instructions = (B * r * 2 * PRODUCT + B * r * ns * (4 * PRODUCT + 6 * ADD) + B * r * n_chunks * (2 * maxdeg * EMUL + 2 * ADD)
                    + B * (EMUL + 2 * ADD) + B * r * (EMUL + 2 * ADD))
    n_words = 6 * B + 4 * B * r + 2 * pps.re.numel() + 4 * B * ns + 2 * B * r + ns + 2 * B * (r + r * n_chunks)
    w = weights or {"mul": PRODUCT, "mul_add": PRODUCT + ADD, "mul_add2": PRODUCT + 2 * ADD, "emul": EMUL, "sub": ADD}
    L = kernels.partial_products_lanes(maxdeg)
    steps, levels = -(-maxdeg // L), L.bit_length() - 1
    lane = (2 * w["mul"] + steps * (2 * w["mul_add2"] + 2 * w["mul_add"]) + 2 * (steps - 1) * w["emul"]
            + (levels + 1 if L > 1 else 2) * w["emul"] + 2 * w["sub"])
    kernel = B * r * (n_chunks * L * lane + 2 * w["emul"] + 4 * w["sub"])
    what = (f"partial_products: (B, r) ({B}, {r}), {ns} routed wires in {n_chunks} chunks of {maxdeg}; {L} lanes a chunk, "
            f"{steps} wires a lane, {levels} tree levels: the kernel's {kernel} instructions")
    return instructions, 8 * n_words, what, kernel


def lookup_work(lkp_sels, wires, lookup_zs, lookup_zs_next, deltas, coeffs, offsets, num_routed_wires, maxdeg, *, product=PRODUCT, add=ADD):
    """(int32 instructions, bytes, description, the kernel's instructions)
    of one lookup_checks launch, counted in the running pair's form (the
    least this code knows), a (b, round): a lookup slot's combo (2 products,
    2 adds), its term (2 adds) and the pair's 2 emuls and 2 adds; a table
    slot the same with a third emul (its multiplicity); a chunk's
    difference, 2 emuls by it, an add, 2 emuls by the selectors; an RE step
    a combo and an escale (4 products, 4 adds), then a subtraction and an
    emul; a padded table row 2 products and 2 adds, a table's final a
    product, 3 adds and an emul; the three single equations 3 emuls. The
    openings, challenges and padded tables read once, each output written
    once. The kernel (csrc/plonk.cu, its lanes kernels.lookup_split's for
    the longest table) runs the slots as these, and besides: on every lane
    of a chunk the pairs' meetings, 3 emuls and 2 adds a pair a tree level;
    on every lane of the RE transition and of a table its segment's steps
    (a step past the last value too), q = delta^S by squarings and a tree
    level's product, add and squaring. An emul is 5 products and 2 adds;
    `product` and `add` are the instructions a product and an add count
    (W's reckoning unless given)."""
    emul = 5 * product + 2 * add
    B, r = wires.shape[0], len(deltas)
    n_polys = lookup_zs.shape[1] // r
    n_sldc, num_lu, num_lut = n_polys - 1, num_routed_wires // 2, num_routed_wires // 3
    rows, luts = coeffs.shape[0], offsets.numel() - 1
    slot = 2 * product + 4 * add
    slots = num_lu * (slot + 2 * emul + 2 * add) + num_lut * (slot + 3 * emul + 2 * add)
    equations = n_sldc * (4 * emul + 6 * add) + 2 * add + emul + luts * (product + 3 * add + emul) + 3 * emul
    per_round = slots + equations + num_lut * (4 * product + 4 * add) + rows * 2 * (product + add)
    chunk, re_lanes, table_lanes = kernels.lookup_split(num_routed_wires, n_sldc, maxdeg, offsets.tolist())
    levels = lambda lanes: lanes.bit_length() - 1
    segments = lambda lanes, n, step, tree: lanes * (-(-n // lanes) * step + levels(lanes) * (product + tree))
    table_rows = (offsets[1:] - offsets[:-1]).tolist()
    kernel_round = (slots + equations + n_sldc * chunk * levels(chunk) * 2 * (3 * emul + 2 * add)
                    + segments(re_lanes, num_lut + 1, 4 * product + 4 * add, 3 * product + 2 * add)
                    + sum(segments(table_lanes, n, 2 * (product + add), 2 * (product + add) + product) for n in table_rows))
    width = 4 + luts + 2 * n_sldc
    n_words = 2 * B * (4 + luts) + 2 * B * max(2 * num_lu, 3 * num_lut) + 4 * B * r * n_polys + 4 * B * r + 2 * rows + luts + 1 + 2 * B * r * width
    what = (f"lookup_checks: (B, r) ({B}, {r}), {n_sldc} SLDC chunks, {num_lu} lookup and {num_lut} table slots, {luts} tables of {rows} "
            f"padded rows; lanes {chunk} a chunk, {re_lanes} the RE transition, {table_lanes} a table: the kernel's {B * r * kernel_round} instructions")
    return B * r * per_round, 8 * n_words, what, B * r * kernel_round


def gate_filter_work(gate_sels, cons, cols, consts, mask, n_gc):
    """(int32 instructions, bytes, description) of one gate_filter launch,
    the least the function needs: a (lane, live gate) its selector value,
    a subtraction a live factor (2 adds) and an emul a factor past the
    first; a (lane, slot, live gate) term an emul and the sum's add (2
    adds); the selector columns it reads, the constraints and the rows read
    once, the output written once."""
    B, L = cons.shape[0], cols.shape[0]
    lanes = min(kernels.GATE_FILTER_LANES, kernels.GATE_FILTER_MAX_LIVE // max(L, 1))
    factors = [int(x) for x in mask.sum(dim=1)]
    per_lane = sum(2 * ADD * f + EMUL * max(f - 1, 0) for f in factors)
    instructions = B * (L * n_gc * (EMUL + 2 * ADD) + per_lane)
    n_words = 2 * B * len(set(cols.tolist())) + 2 * B * L * n_gc + 2 * B * n_gc + L + consts.numel()
    what = (f"gate_filter: {B} lanes, {L} live gates of {n_gc} constraints, {sum(factors)} live factors in rows of {consts.shape[1]} slots, "
            f"{lanes} lanes a block")
    return instructions, 8 * n_words + mask.numel(), what


def random_arrays(tpl, batch: int, queries: int, rng):
    """Arrays of the shapes flatten_proofs gives `tpl`, the per-query ones at
    `queries` rounds: random words with the edge band and words x + p among
    them (tools/check_field_kernels.words)."""
    from .check_field_kernels import words

    B, Q = batch, queries
    shapes = {
        "circuit_digest": (B, 4), "public_inputs": (B, tpl.n_pi), "pow_witness": (B,), "final_poly": (B, tpl.final_poly_len, 2),
        "openings1": (B, tpl.n_const_cols + tpl.n_sigmas + tpl.num_wires + tpl.n_zs + tpl.n_pp + tpl.n_quot + tpl.n_lookup, 2),
        "openings2": (B, tpl.n_zs + tpl.n_lookup, 2),
    }
    shapes.update({k: (B, tpl.cap_len, 4) for k in ("cap_cs", "cap_w", "cap_zp", "cap_q")})
    for o, w in enumerate(tpl.oracle_widths):
        shapes.update({f"leaves_{o}": (B, Q, w), f"sibs_{o}": (B, Q, tpl.initial_path_len, 4)})
    for s, st in enumerate(tpl.steps):
        shapes.update({f"step_cap_{s}": (B, st["cap_len"], 4), f"step_evals_{s}": (B, Q, 1 << st["arity_bits"], 2),
                       f"step_sibs_{s}": (B, Q, st["path_len"], 4)})
    return {k: words(rng, shape) for k, shape in shapes.items()}


def recorded_calls(targets, v, a, queries=None):
    """The arguments of every call of the functions `targets` names, each an
    (owner, attribute) pair (a module's wrapper, the kernel library's
    launch method, or a class's method, whose args then begin with the
    instance), during one call of `v` on the arrays `a`, in call order:
    [(attribute, args, kwargs)]. The call's launches count where they are made."""
    calls, originals = [], [(owner, name, getattr(owner, name)) for owner, name in targets]
    for owner, name, fn in originals:
        def record(*args, _name=name, _fn=fn, **kwargs):
            calls.append((_name, args, kwargs))
            return _fn(*args, **kwargs)

        setattr(owner, name, record)
    try:
        with torch.no_grad():
            v(a, queries)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    return calls


def output_tensors(x):
    """An output (a tensor, a GExt, lists and tuples of them) as a list of
    tensors, each with the batch axis first (a GExt's parts stacked after it)."""
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in output_tensors(y)]
    return [torch.stack([x.re, x.im], dim=1)] if isinstance(x, tf.GExt) else [x]


def words_of(x):
    """Every word of an output as one flat tensor."""
    return torch.cat([t.reshape(-1) for t in output_tensors(x)])


def probe_sponge_groups(lib, rng, rate):
    """The grouped launch beside one launch a matrix, on the matrices of
    SPONGE_GROUPS."""
    for name, shapes in SPONGE_GROUPS.items():
        group = [tf.from_u64(rand_words(rng, shape), "cuda") for shape in shapes]
        perms = sum(n * -(-w // 8) for n, w in shapes)
        bound = bound_ms(perms, sum(n * (w + 4) * 8 for n, w in shapes), rate)[0]
        for g, rows in zip(lib.sponge_rows_grouped(group), group):
            if not torch.equal(g, lib.sponge_rows(rows, rows.shape[1])):
                raise AssertionError(f"{name}: grouped launch differs from sponge_rows at {tuple(rows.shape)}")
        apart = event_ms(lambda: [lib.sponge_rows(rows, rows.shape[1]) for rows in group], 20, 3)
        ms = event_ms(lambda: lib.sponge_rows_grouped(group), 20, 3)
        print(f"sponge group {name} ({perms} permutations): one launch {ms:.4f} ms, six launches {apart:.4f} ms, "
              f"bound {bound:.4f} ms, share {bound / ms:.3f}")


# the main path's Horner sums at batch 1024, 28 queries: (what, rows of
# values, K, base-field values, base-field point, v_rep, p_rep, column stride 2)
HORNER_SHAPES = [
    ("combineInitial's g0", 28672, 254, True, False, 1, 28, False),
    ("the reduced opening y0", 1024, 254, False, False, 1, 1, True),
    ("a coset fold", 28672, 16, False, False, 1, 28, False),
    ("the final polynomial", 1024, 16, False, True, 28, 1, False),
    ("horner_scaled", 1024, 42, False, True, 2, 1, False),
]


def probe_field(lib, rng, rate):
    """The Horner sum at HORNER_SHAPES and the gate program at 1024 lanes,
    each timed beside its bound: by events, on the device
    (bench_poseidon.device_ms) and the host's time to enqueue a call."""
    from ..compiler.gates_torch import GateProgram, step_barriers
    from .check_field_kernels import gate_inputs, gate_programs

    for what, rows, k, base_v, base_p, v_rep, p_rep, strided in HORNER_SHAPES:
        n = rows * v_rep
        v = tf.from_u64(rand_words(rng, (rows, k, 2)), "cuda")
        v_re, v_im = (v[..., 0], v[..., 1]) if strided else (v[..., 0].contiguous(), v[..., 1].contiguous())
        v_im = None if base_v else v_im
        p = tf.from_u64(rand_words(rng, (n // p_rep, 2)), "cuda")
        p_re, p_im = p[:, 0], None if base_p else p[:, 1]
        args = (v_re, v_im, p_re, p_im, v_rep, p_rep)
        bound = field_bound_ms(*horner_work(args), rate)[0]
        run = lambda: lib.horner(*args)
        dev = device_ms(run, 20, 3)
        print(f"horner {what} ({rows} x {v_rep}, {k}), S = {kernels.horner_segments(n, k, lib.sms)}, bound {bound:.4f} ms: "
              f"by events {event_ms(run, 20, 3):.4f} ms, device {dev:.4f} ms (share {bound / dev:.3f}), the host's enqueue {_host_ms(run, 20):.4f} ms")
    for name, lp in gate_programs():
        if name not in ("fibonacci", "gate zoo"):
            continue
        prog = GateProgram(lp, "cuda")
        packed = prog.pack()
        inputs, views = gate_inputs(rng, lp, 1024, "cuda")
        bound = field_bound_ms(*gate_work(packed, inputs), rate)[0]
        plan = lib.gate_plan(1024, packed)
        run = lambda: lib.gate_program(views, packed)
        dev = device_ms(run, 20, 3)
        print(f"gate_program {name}: {packed.n_steps} steps, {packed.n_slots} slots, the library's plan {plan}, "
              f"{step_barriers(packed.step_off.cpu().numpy(), plan['lanes'])} block barriers, bound {bound:.4f} ms: "
              f"by events {event_ms(run, 20, 3):.4f} ms, device {dev:.4f} ms (share {bound / dev:.3f}), the host's enqueue {_host_ms(run, 20):.4f} ms")


# csrc/probe_field_sass.cu's OP 0-8
SASS_OPS = ("mul", "add", "sub", "emul", "emul by a Point", "escale", "mul_add", "mul_add2", "emul_once")


def field_sass_counts() -> dict:
    """The SASS instructions one of goldilocks.cuh's ops executes inside a
    dependent chain, by op (SASS_OPS) and opcode: csrc/probe_field_sass.cu
    compiled to a cubin as the kernels are, read with cuobjdump, each op's
    chain of 8 less its chain of 4, over 4. Needs nvcc and cuobjdump."""
    nvcc = kernels._nvcc()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(kernels.BUILD_DIR, f"probe_field_sass.{os.getpid()}.cubin")
    cmd = [nvcc, *kernels.ARCH_FLAGS, "-cubin", "-o", cubin, os.path.join(kernels.CSRC, "probe_field_sass.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    try:
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True, check=True).stdout
    finally:
        os.remove(cubin)
    chains, chain = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"count_kernelILi(\d)ELi(\d)E", line)
            chain = chains.setdefault((int(m.group(1)), int(m.group(2))), {}) if m else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*(?:\.(?:WIDE|MOV|HI|X))?)", line)
        if chain is not None and m and m.group(1) != "NOP":
            chain[m.group(1)] = chain.get(m.group(1), 0) + 1
    counts = {}
    for k, name in enumerate(SASS_OPS):
        if (k, 4) not in chains or (k, 8) not in chains:
            raise RuntimeError(f"the chains of {name} were not found in the SASS")
        long, short = chains[k, 8], chains[k, 4]
        by_op = {op: (long.get(op, 0) - short.get(op, 0)) / 4 for op in set(long) | set(short)}
        counts[name] = {op: n for op, n in by_op.items() if n}
    return counts


def template(name: str, params: dict):
    """The CircuitTemplate of a cached fixture (models.cache proves it first
    where it is not cached)."""
    from ..compiler import CircuitTemplate
    from ..models.cache import get_fixture_proof

    return CircuitTemplate(get_fixture_proof(name, **params)[0])


# a stage kernel's wrapper in verifier_torch: (its launch counter, its work, its plain version)
STAGES = {"coset_folds": ("coset_fold", fold_work, vt.coset_folds_plain),
          "partial_products": ("partial_products", partial_products_work, vt.partial_products_plain),
          "lookup_checks": ("lookup_checks", lookup_work, vt.lookup_checks_plain),
          "gate_filter": ("gate_filter", gate_filter_work, vt.gate_filter_plain)}


def stage_times(rate) -> dict:
    """Each stage kernel's call in one forward of the standard fibonacci
    template at BATCH (the lookup argument: of the gate zoo's) on random
    proof words, held bit-exact against its plain version, then timed by
    events and on the device beside its bound. Returns, by counter, the
    times and the call's arguments."""
    rng = np.random.default_rng(7)
    out = {}
    for name, params in [("fibonacci", STANDARD), ("gate_zoo", ZOO)]:
        v = vt.TorchVerifier(template(name, params))
        arrays = v.prepare(random_arrays(v.tpl, BATCH, v.tpl.num_queries, rng))
        for wrapper, args, kwargs in recorded_calls([(vt, k) for k in STAGES], v, arrays):
            counter, work, plain = STAGES[wrapper]
            if counter in out:
                continue
            run = lambda fn=getattr(vt, wrapper), args=args, kwargs=kwargs: fn(*args, **kwargs)
            if not torch.equal(words_of(run()), words_of(plain(*args))):
                raise AssertionError(f"{wrapper} on {name}'s call differs from the plain version")
            instructions, n_bytes, what, *_ = work(*args)
            b_ms, by = field_bound_ms(instructions, n_bytes, rate)
            ms, dev = event_ms(run, 20, 2), device_ms(run, 20, 1)
            print(f"time {counter} ({name}: {what}): {ms:.4f} ms (device {dev:.4f} ms), bound {b_ms:.4f} ms ({by}; {instructions} int32 "
                  f"instructions, {n_bytes} bytes), share of bound {b_ms / ms:.3f} (device {b_ms / dev:.3f})")
            out[counter] = {"ms": ms, "device_ms": dev, "bound_ms": b_ms, "bound_by": by, "timed_on": name, "args": args}
    return out


def probe_stages(rate, smi: str):
    """stage_times as one JSON line, then the SASS instructions each of
    goldilocks.cuh's ops executes (field_sass_counts) and the three stage
    kernels' own counts at those weights beside their device time."""
    times = stage_times(rate)
    rows = {k: {x: y for x, y in t.items() if x != "args"} for k, t in times.items()}
    print(json.dumps({"card": smi, **rows}))

    sass = field_sass_counts()
    for name, ops in sass.items():
        print(f"sass {name}: {sum(ops.values()):g} instructions: " + ", ".join(f"{op} {n:g}" for op, n in sorted(ops.items(), key=lambda kv: -kv[1])))
    total = {name: sum(ops.values()) for name, ops in sass.items()}
    product, add = total["mul"], total["add"]
    weights = {"mul": product, "mul_add": total["mul_add"], "mul_add2": total["mul_add2"], "emul": total["emul_once"], "sub": total["sub"]}
    issue = rate / INT32_LANES_PER_SM * 128  # 4 schedulers an SM, each a warp instruction a clock
    fold_args, lookup_args, pp_args = (times[k]["args"] for k in ("coset_fold", "lookup_checks", "partial_products"))
    counts = {"coset_fold": (fold_work(*fold_args)[3], fold_work(*fold_args, product=product, add=add)[3], f"{product:g} a product and {add:g} an add"),
              "lookup_checks": (lookup_work(*lookup_args)[3], lookup_work(*lookup_args, product=product, add=add)[3],
                                f"{product:g} a product and {add:g} an add"),
              "partial_products": (partial_products_work(*pp_args)[3], partial_products_work(*pp_args, weights=weights)[3],
                                   ", ".join(f"{k} {n:g}" for k, n in weights.items()))}
    for name, (at_w, at_sass, weighed) in counts.items():
        ms = times[name]["device_ms"]
        print(f"sass {name}: its own count {at_w} instructions at {PRODUCT} a product and {ADD} an add, {at_sass} at {weighed} "
              f"(the SASS counts above); over its device {ms:.4f} ms: {at_w / ms * 1e3:.4g} /s = {at_w / ms * 1e3 / rate:.3f} of the int32 rate, "
              f"{at_sass / ms * 1e3:.4g} SASS /s = {at_sass / ms * 1e3 / rate:.3f} of the int32 rate ({rate:.4g} /s), "
              f"{at_sass / ms * 1e3 / issue:.3f} of the issue rate ({issue:.4g} /s)")


def probe_lookup_lanes(rng):
    """The lookup kernel's device ms on the zoo's call under other lanes."""
    v = vt.TorchVerifier(template("gate_zoo", ZOO))
    ((_, args, kwargs),) = recorded_calls([(vt, "lookup_checks")], v, v.prepare(random_arrays(v.tpl, BATCH, v.tpl.num_queries, rng)))
    want = words_of(vt.lookup_checks_plain(*args))
    routed, maxdeg, n_sldc, bounds = args[7], args[8], v.tpl.common.num_lookup_polys - 1, args[6].tolist()
    for slots in (1, 2, 4, 8):
        for values in (1, 2, 4, 8):
            lanes = kernels.lookup_split(routed, n_sldc, maxdeg, bounds, slots, values)
            run = lambda: vt.lookup_checks(*args, lanes=lanes)
            if not torch.equal(words_of(run()), want):
                raise AssertionError(f"lookup_checks on lanes {lanes} differs from the plain version")
            shipped = (slots, values) == (kernels.LOOKUP_SLOTS_A_LANE, kernels.LOOKUP_VALUES_A_SEGMENT)
            print(f"lookup lanes: {slots} slots a lane, {values} values a segment -> lanes {lanes}"
                  f"{' (shipped: ' + str(kwargs['lanes']) + ' on the main path)' if shipped else ''}: device {device_ms(run, 20, 3):.4f} ms")


def cycles_probe() -> str:
    """Build csrc/probe_cycles.cu into csrc/_build/ and return its output."""
    nvcc = kernels._nvcc()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    exe = os.path.join(kernels.BUILD_DIR, f"probe_cycles.{os.getpid()}")
    cmd = [nvcc, *kernels.ARCH_FLAGS, "-I", kernels.CSRC, "-o", exe, os.path.join(kernels.CSRC, "probe_cycles.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    try:
        return subprocess.run([exe], capture_output=True, text=True, check=True).stdout.strip()
    finally:
        os.remove(exe)


def main():
    smi, rate = device_phase()
    t = time.time()
    lib = kernels.load()
    print(f"build_s {time.time() - t:.1f}")
    if "--stages" in sys.argv[1:]:
        probe_stages(rate, smi)
        return
    if "--lookup-lanes" in sys.argv[1:]:
        probe_lookup_lanes(np.random.default_rng(5))
        print(f"card: {smi}")
        return
    consts = tp.PoseidonConstants()
    check_kernels(lib, consts, n_random=5000)

    rng = np.random.default_rng(3)
    if "--field" in sys.argv[1:]:
        probe_field(lib, rng, rate)
        print(f"card: {smi}")
        return
    for n in PERM_SIZES:
        x = tf.from_u64(rand_words(rng, (n, 12)), "cuda")
        ms = {f: event_ms(lambda: lib.permutation(x, f), 50, 5) for f in ("thread", "split")}
        print(f"permutation n={n}: thread {ms['thread']:.4f} ms, split {ms['split']:.4f} ms, bound {bound_ms(n, n * 192, rate)[0]:.5f} ms")

    mask = np.zeros((N_PERMS, 12), dtype=bool)
    mask[:, :8] = True
    idx = (np.arange(N_PERMS * 12).reshape(N_PERMS, 12) % N_DATA).astype(np.int64)
    ov_idx, ov_mask = torch.from_numpy(idx).cuda(), torch.from_numpy(mask).cuda()
    for batch in SCAN_BATCHES:
        data = tf.from_u64(rand_words(rng, (batch, N_DATA)), "cuda")
        ms = {f: event_ms(lambda: lib.permutation_scan(data, ov_idx, ov_mask, f), 5, 2) for f in ("thread", "split")}
        print(f"scan B={batch}: thread {ms['thread']:.4f} ms, split {ms['split']:.4f} ms, bound {bound_ms(batch * N_PERMS, 0, rate)[0]:.5f} ms")

    for n, path_len in MERKLE_SHAPES:
        dig = tf.from_u64(rand_words(rng, (n, 4)), "cuda")
        index = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.int64)).cuda()
        sib = tf.from_u64(rand_words(rng, (n, path_len, 4)), "cuda")
        ms, bound = event_ms(lambda: lib.merkle_fold(dig, index, sib), 20, 3), bound_ms(n * path_len, 0, rate)[0]
        print(f"merkle_fold ({n}, L={path_len}): {ms:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f}")
    for n, width in SPONGE_SHAPES:
        rows = tf.from_u64(rand_words(rng, (n, width)), "cuda")
        ms, bound = event_ms(lambda: lib.sponge_rows(rows, width), 20, 3), bound_ms(n * -(-width // 8), 0, rate)[0]
        print(f"sponge_rows ({n}, {width}): {ms:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f}")
    probe_sponge_groups(lib, rng, rate)
    probe_field(lib, rng, rate)

    print(cycles_probe())
    print_sass()
    print(f"card: {smi}")


if __name__ == "__main__":
    sys.exit(main())
