#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: build the kernels (the
three Poseidon kernels, the three field kernels -- the extension Horner
sum, the Fermat inversion and the exponentiations -- the levelized gate
program, the FRI coset folds, and L0 with the partial products, the
lookup argument and the gate filter), hold each against its plain PyTorch version and the golden model,
time both, then verify a batch of 1024 standard-shape fibonacci proofs
through TorchVerifier and check verdicts and transcripts, then batches
of 512 and 1024 proofs of the gate-zoo circuit (all 16 gate kinds and the
lookup argument) the same way, then the serving path: 10,000 proofs as raw
JSON bytes through the native C++ ingest and StreamVerifier, both shapes
mixed through the command line, and small circuits of many shapes, then
several devices as a process each, all on the one card, and a profile of one
verifier call at both shapes.

Run from the repository root:  python3 chip_smoke.py

Phases (any failed check raises, so the last line is printed only on
success):
1. device: needs CUDA; prints nvidia-smi's name and power limit, and the
   host compiler (g++) that the native ingest is built with;
2. build: compiles csrc/*.cu with nvcc (kernels.load) and prints seconds;
3. kernel checks: each kernel bit-exact against its *_plain version on the
   card, on the known-answer state, the p-edge band, 2^20 + 37 random states
   (the permutation in both of its forms, a state per thread and a state per
   half-warp), every sponge width and every path length used, plus rows
   against golden/; the grouped sponge entry point on every width mixed in
   one launch (row counts that are no multiple of the block, an empty
   segment, the edge band) against its plain version, against the
   one-matrix entry point and against golden/; the transcript-scan entry
   point against the plain loop on a real schedule at batch 1, 5 and 1024,
   and lane 0 against golden/; the Fermat inversion on 2^20 random words,
   the edge band and words x + p, and its grouped form (the batch trick)
   on the same words and on lengths around its group with a zero and a p in
   every position of a group, the Horner sum with both of its flags,
   repeated rows, column stride 2, K = 0 and no rows, the exponentiations
   on 2^20 words in every flag pair (exponents 0, 1, 2^n - 1 and random; a
   scalar and a repeated base) and in their grouped form (fixed-generator
   segments as the verifier makes them, from a table of 2^k powers, beside
   extension bases at host exponents, in one launch and apart), and the
   gate program of the fibonacci,
   poseidon_chain, gate-zoo and fuzz 13 / 23 circuits in both of its forms
   (the tapes in shared memory, in device scratch), at batches whose lanes
   a block do and do not divide them and at B = 0, the coset folds (arity
   2 to 64 in one launch, staged in shared memory and in scratch, a query
   slice, B = 0), L0 with the partial products (r, maxdeg and chunk
   counts), the lookup argument (SLDC chunks, table counts and lengths,
   the lanes each gets, subtrahends y + p) and the gate filter (templates
   of one selector group and of several, rows of one live slot, of none and
   with gaps, batches 1, 1,023 and 16,384) (tools/check_field_kernels.py);
4. main path: the standard fixture (degree 12, 28 queries, PoW 16; proved
   by a child process that starts with phase 2 and is waited for here),
   batch 1024, all accepted; lane 0's transcript equal to golden; six single-array
   mutations rejected on exactly their lanes; a 4-lane heterogeneous batch
   accepted with every lane's transcript equal to golden, and every kernel
   held against its plain version at that small batch's shapes
   (hold_against_plain; phase 5 does so at batch 1024); over the main-path
   run the scan was launched at least once and the sponge and Merkle kernels
   more than zero times (the sponge twice: the public-input hash and one
   grouped launch for every leaf hash), the Horner sum exactly 7 times,
   every inversion of a call in one grouped launch and every
   exponentiation in another (the one-call inversion and exponentiation
   never), the gate program once, every fold step's coset fold in one
   launch, L0 with the partial products and the gate filter once and the
   lookup argument once where the template has lookups (`_field_launches`;
   every path below
   checks these counts too);
5. kernel times at the main path's shapes (batch 1024), kernel and plain,
   each pair also compared bit for bit, each beside its bound (the integer
   work W of csrc/poseidon.cuh over the card's int32 rate at its maximum SM
   clock, or the bytes over 3.35 TB/s, whichever is larger); the
   permutation's step time in both forms at n = 64 ... 16384; the grouped
   sponge launch over the six row matrices of one verifier call, at the
   fibonacci path's widths and at the gate zoo's, beside the same matrices
   hashed one launch each; every Horner sum and the grouped inversion of
   one main-path call on its own arguments, each beside its plain version
   and its bound, the inversion also beside the same words inverted one
   call a denominator as before it was grouped; the grouped exponentiation
   and the gate program of one main-path call and of one gate-zoo call
   (batch 1024, random proof words), each beside its plain version and its
   bound, the exponentiation also beside one call a power; the coset
   folds, L0 with the partial products, the gate filter and the lookup
   argument (the gate zoo's alone) likewise;
6. timing: 5 verifier calls after warm-up, each until its verdict is on
   the host (bench.time_calls, the benchmark's own timing) -> proofs/s and
   step ms of the median call, and the transcript alone; then
   `python3 bench_torch.py` once in a process of its own (10 timed calls at
   batch 1024 on the standard fixture and the kernels of this run): exit 0,
   one JSON line, every proof accepted, its seeded fault lanes rejected,
   every kernel the main path launched launched, the card named as
   nvidia-smi names it;
7. second path: the gate-zoo fixture with lookups (degree 12, 28 queries,
   PoW 16; proved by a child process that starts with phase 2 and is waited
   for here), at batch 512 and 1024: all accepted, lane 0's transcript
   (the lookup deltas among it) equal to golden, seven single-array
   mutations (one a lookup opening inside openings1) rejected on exactly
   their lanes through verify_batch, the launch counters set to 0 before the
   first call and read after it, every kernel held against its plain version
   at this template's shapes at that batch, then step ms and proofs/s;
8. ingest: the native C++ parser must have built (no Python tier here); 64
   standard-shape (vkey, proof) JSON byte pairs through it, with one worker
   and with several, equal flatten_proofs of the same proofs; native and
   Python ms a proof, JSON bytes a proof (tools/bench_ingest.py);
9. third path, the stream: 10,000 standard-shape proofs as raw JSON byte
   pairs, every 1,000th with a flipped pow_witness, through
   StreamVerifier(tpl, 1024, raw_json=True): 9,990 accepted, 10 rejected, 10
   batches (the last of 784 live lanes); over the run the scan was launched
   10 times, the sponge 20 (10 one-matrix, 10 grouped) and the Merkle walk
   30; the Python ingest tier is made to raise for the run; the final
   snapshot beside the first path's step, the copy ms a batch, and the share
   of the ingest that the prefetch hid; ingest_s + device_wait_s must not
   exceed elapsed_s (the kernels' shapes are those of phase 5);
10. the command line: both cached triples in a temporary directory through
   `stream DIR --batch 512 --repeat 1024` (two shapes, 1,024 accepted each,
   exit code 0, every kernel launched once a batch and the Merkle walk three
   times) and `verify PREFIX --batch 4` (exit code 0), in process; then every
   kernel against its plain version at the first shape at batch 512 and at
   batch 4 (phase 7 held the second at 512);
11. shape variety (run between phases 3 and 4, while the child processes
   still prove): the six-point shape grid and fuzz seeds 13 and 23
   (tools/shape_circuits.py) through TorchVerifier at batch 2: accepted,
   lane 0's transcript equal to golden, and a batch with one fault a lane
   rejected on exactly those lanes; then every kernel against its plain
   version at each circuit's shapes at both of those batch sizes;
12. fourth path, several devices as a process each, all on the one card and
   joined by gloo (parallel/mesh.py; the children load the kernel library
   built in phase 2 and the fixture cached in phase 4): 2 x 1, 1 x 2 and
   2 x 2 meshes through ShardedVerifier on a global batch of 1024 standard
   proofs with a flipped pow_witness in one dp shard and a flipped opening in
   the other: every rank's lanes and the gathered verdict equal the
   one-process TorchVerifier's on the same arrays, n_valid 1022 on every
   rank, lane 0's transcript equal to golden in the ranks that hold it; each
   rank's launch counters set to 0 before its first call and read after it
   (scan 1, sponge 1 + 1, Merkle 3); the last rank of the 1 x 2 mesh and of
   the 2 x 2 mesh holds every kernel against its plain version at its shapes
   (1024 and 512 lanes, 14 queries); two timed calls a rank between barriers. Then 8,192 raw-JSON
   proofs, every 1,000th corrupt, through StreamVerifier(tpl, 2048,
   mesh=2 x 1): 8,184 / 8 and 4 batches on both ranks, launches a rank 4 / 8
   / 12, proofs/s over all beside phase 9's one-process stream;
13. tools/profile_verifier.py at the standard shape and at the gate zoo's,
   batch 1024: stage times (the tracer's spans, device ms), cudaLaunchKernel
   calls a forward, kernel time and the card's idle share (torch.profiler),
   seconds to construct, for the first call and for a warm call.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.

With --sass it also prints the SASS instructions one permutation executes
(kernels.sass_instruction_count; needs cuobjdump), a cross-check of the
kernels' distance from W, beside the count of the round body before this one
(SASS_BEFORE) and the count of a 2-to-1 compression.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024
DEVICE = None  # the card; a rehearsal on the CPU sets "cpu" with a stand-in kernel library
STANDARD = {"n_arith_rows": 4093, "num_query_rounds": 28, "proof_of_work_bits": 16}
ZOO = {"target_degree_bits": 12, "num_query_rounds": 28, "proof_of_work_bits": 16}  # the gate-zoo shape
ZOO_BATCHES = [512, 1024]
TIMED_CALLS = 5
ZOO_TIMED_CALLS = 2
BENCH_ITERS, BENCH_TIMEOUT_S = 10, 300  # bench_torch.py's timed calls in its one run here, and its time limit
INGEST_PROOFS = 64
STREAM_PROOFS, STREAM_CORRUPT_EVERY = 10_000, 1000
CLI_BATCH, CLI_REPEAT, CLI_VERIFY_BATCH = 512, 1024, 4
STEP_SIZES = [64, 1024, 4096, 16384]
MESHES = [(2, 1), (1, 2), (2, 2)]  # dp x qp, every rank on the one card
MESH_HOLDS = [(1, 2), (2, 2)]  # the meshes whose last rank holds the kernels against plain at its shapes
MESH_BATCH, MESH_TIMED_CALLS, MESH_TIMEOUT_S = 1024, 2, 300
MESH_STREAM_DP, MESH_STREAM_BATCH, MESH_STREAM_PROOFS = 2, 2048, 8192
PROFILE = [("fibonacci", 1024), ("gate_zoo", 1024)]  # tools/profile_verifier.py's (model, batch)
# The yardstick (csrc/poseidon.cuh): W 32-bit integer instructions a
# permutation, over SMs x 64 int32 lanes x the maximum SM clock; bytes over
# the H100's 3.35 TB/s beside it.
W_INSTRUCTIONS = 19180
# the SASS instructions of one thread-form permutation under the round body
# before csrc/poseidon.cuh's present one (its own count kernels: the first
# constants, 8 full and 22 partial rounds), printed beside today's by --sass
SASS_BEFORE = {"IMAD.WIDE": 11366, "IADD3": 10510, "IADD3.X": 3796, "VIADD": 1874, "UMOV": 1486, "IMAD.MOV": 1264, "IMAD.X": 984,
               "SEL": 880, "ISETP": 768, "ULDC": 552, "MOV": 458, "IMAD.IADD": 432, "IMAD": 266, "LDC": 180, "S2R": 30}
INV_PRODUCTS = 72  # csrc/field.cu's chain for a^(p - 2): 63 squarings and 9 products
POW_WINDOW = 8  # bits a table of the least work of a fixed-generator power (pow_grouped_work)
# int32 instructions of a Goldilocks product and add (W's reckoning), and of the
# extension ops built from them: an emul is 5 products and 2 adds
PRODUCT, ADD = 16, 4
EMUL = 5 * PRODUCT + 2 * ADD
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True).stdout.splitlines()[0])
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
    compression (kernels.sass_instruction_count), by opcode, beside W and
    beside SASS_BEFORE. Needs nvcc and cuobjdump."""
    from plonky2_verifier_tpu_torch import kernels

    pieces = kernels.sass_pieces()
    counts = kernels.sass_instruction_count(pieces=pieces)
    compression = sum(kernels.sass_instruction_count(compression=True, pieces=pieces).values())
    by_op = lambda c: ", ".join(f"{k} {n}" for k, n in sorted(c.items(), key=lambda kv: -kv[1]))
    print(f"sass: {sum(counts.values())} instructions in one thread-form permutation (W = {W_INSTRUCTIONS}), "
          f"{compression} in a 2-to-1 compression: {by_op(counts)}")
    print(f"sass before: {sum(SASS_BEFORE.values())} instructions in one thread-form permutation: {by_op(SASS_BEFORE)}")
    print("sass pieces: " + ", ".join(f"{k} {sum(ops.values())}" for k, ops in sorted(pieces.items())))


def bound_ms(permutations: int, n_bytes: int, rate: float):
    """(bound ms, "operations" or "bytes"): the larger of the integer work
    over the card's int32 rate and the bytes over its memory rate."""
    ops_ms = permutations * W_INSTRUCTIONS / rate * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def field_bound_ms(instructions: int, n_bytes: int, rate: float):
    """(bound ms, "operations" or "bytes") of a field kernel: its int32
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


def random_arrays(tpl, batch: int, queries: int, rng):
    """Arrays of the shapes flatten_proofs gives `tpl`, the per-query ones at
    `queries` rounds: random words with the edge band and words x + p among
    them (tools/check_field_kernels.words)."""
    from plonky2_verifier_tpu_torch.tools.check_field_kernels import words

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
    import torch

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


def hold_field_kernels(v, batches, parts, checks, what: str, rng, queries=None):
    """The field kernels' share of hold_against_plain: every Horner sum,
    inversion, exponentiation, the gate program, the coset folds, L0 with
    the partial products, the gate filter and the lookup argument (where the template has
    lookups) of one call of `v` on random words over all the lanes,
    recorded with its views (stride-0 rows, scalar bases and views of the
    openings among them); each wrapper then runs on each batch size's lanes
    and the plain version once on all. A buffer of `v` (a constant of the
    template) is passed whole. Returns the calls' shapes after the batch
    axis."""
    import torch

    from plonky2_verifier_tpu_torch import verifier_torch as vt
    from plonky2_verifier_tpu_torch.compiler.gates_torch import GateProgram
    from plonky2_verifier_tpu_torch.ops import field as tf

    Q = queries or v.tpl.num_queries
    a = v.prepare(random_arrays(v.tpl, sum(batches), Q, rng))
    targets = [(vt, "horner_ext"), (vt, "horner_scaled"), (tf, "inv_grouped"), (tf, "pow_grouped"), (GateProgram, "forward")]
    targets += [(vt, "coset_folds"), (vt, "partial_products"), (vt, "lookup_checks"), (vt, "gate_filter")]
    calls = recorded_calls(targets, v, a, None if queries is None else slice(0, Q))
    constants = {id(b) for b in v.buffers()}
    gate = lambda prog, inputs, batch_shape, **kw: GateProgram.forward(prog, inputs, batch_shape, **kw)
    gate_plain = lambda prog, inputs, batch_shape, packed=None, **kw: prog.forward_plain(inputs, batch_shape, **kw)  # packed: the card's
    plain = {"horner_ext": lambda x, p: vt.horner_ext_plain(vt.as_ext(x), vt.as_ext(p)), "horner_scaled": vt.horner_scaled_plain,
             "inv_grouped": tf.inv_grouped_plain, "pow_grouped": tf.pow_grouped_plain, "forward": gate_plain, "coset_folds": vt.coset_folds_plain,
             "partial_products": vt.partial_products_plain,
             "lookup_checks": lambda *args, lanes=None: vt.lookup_checks_plain(*args), "gate_filter": vt.gate_filter_plain}  # lanes: the card's
    wrapper = {"horner_ext": vt.horner_ext, "horner_scaled": vt.horner_scaled, "inv_grouped": tf.inv_grouped, "pow_grouped": tf.pow_grouped,
               "forward": gate, "coset_folds": vt.coset_folds, "partial_products": vt.partial_products, "lookup_checks": vt.lookup_checks,
               "gate_filter": vt.gate_filter}
    bucket = {"horner_ext": "horner", "horner_scaled": "horner", "inv_grouped": "inv", "pow_grouped": "pow", "forward": "gate_program",
              "coset_folds": "coset_fold", "partial_products": "partial_products", "lookup_checks": "lookup_checks", "gate_filter": "gate_filter"}

    def cut(x, part, b):
        """x's lanes `part`: a tensor's or GExt's first axis, a dict's, a list's or a segment's items, the batch shape."""
        if isinstance(x, dict):
            return {k: cut(y, part, b) for k, y in x.items()}
        if isinstance(x, tuple) and all(isinstance(y, int) for y in x):  # GateProgram.forward's batch shape
            return (b,)
        if id(x) in constants:
            return x
        if isinstance(x, (list, tuple)):  # inv_grouped's parts, pow_grouped's (base, e) segments
            return type(x)(cut(y, part, b) for y in x)
        return x[part] if isinstance(x, (torch.Tensor, tf.GExt)) else x

    def shape(x):
        if isinstance(x, dict):
            return {k: tuple(y.shape)[1:] for k, y in x.items()}
        if isinstance(x, tf.GeneratorPower):
            return f"g^({x.bits} bits)"
        if isinstance(x, (list, tuple)) and not all(isinstance(y, int) for y in x):
            return [shape(y) for y in x]
        return tuple(x.shape)[1:] if isinstance(x, (torch.Tensor, tf.GExt)) else x

    shapes = []
    for name, args, kwargs in calls:
        want = output_tensors(plain[name](*args, **kwargs))
        described = [shape(x) for x in args if not isinstance(x, GateProgram)]
        for b, part in zip(batches, parts):
            got = output_tensors(wrapper[name](*(cut(x, part, b) for x in args), **kwargs))
            if len(got) != len(want):
                raise AssertionError(f"{what}: {name} at batch {b} gave {len(got)} outputs, the plain version {len(want)}")
            for k, (g, w) in enumerate(zip(got, want)):
                checks[bucket[name]].compare(g, w[part], f"{what}: {name} at batch {b}, {described}, output {k}")
        shapes.append(f"{'GateProgram.forward' if name == 'forward' else name} {described}")
    return shapes


def hold_against_plain(v, batch, checks, what: str, queries=None):
    """Every kernel wrapper against its plain version, bit for bit, on random
    inputs of the shapes that one call of the verifier `v` at `batch` gives
    it: the transcript scan on v's own schedule, the public-input hash (width
    0 where the circuit has none), every leaf hash in one grouped launch, the
    stacked initial Merkle walk and each fold step's, and every Horner sum,
    inversion, exponentiation, the gate program, the coset folds, L0 with
    the partial products, the gate filter and the lookup argument of a call
    on random proof words (hold_field_kernels). A
    walk of length 0 is never launched (verifier_torch.merkle_batched) and
    is passed over here too. `batch` may be a list of batch sizes: each wrapper is then called
    once at each size, and the plain version (lane by lane the same work,
    and thousands of launches whatever the size) once, on all those lanes
    together. These launches are no part of a path's count: call it outside
    the window in which a path's launches are counted. `queries`: the query
    rounds a rank of a mesh with qp > 1 checks, where not all of them."""
    import torch

    from plonky2_verifier_tpu_torch.ops import field as tf
    from plonky2_verifier_tpu_torch.ops import hash as th
    from plonky2_verifier_tpu_torch.ops import poseidon as tp
    from plonky2_verifier_tpu_torch.tools.check_hash_kernels import rand_words

    tpl, consts = v.tpl, v.poseidon
    dev, Q = consts.rc.device, queries or tpl.num_queries
    batches = [batch] if isinstance(batch, int) else list(batch)
    lanes = sum(batches)
    ends = np.cumsum(batches)
    parts = [slice(int(end - b), int(end)) for b, end in zip(batches, ends)]  # the lanes of each batch size
    rng = np.random.default_rng(lanes)
    rand = lambda *shape: tf.from_u64(rand_words(rng, shape), dev)
    t = time.time()

    data = rand(lanes, tpl.schedule.n_data)
    want = tp.permutation_scan_plain(data, v._ov_idx, v._ov_mask, consts)
    for b, part in zip(batches, parts):
        checks["permutation"].compare(
            tp.permutation_scan(data[part], v._ov_idx, v._ov_mask, consts), want[:, part],  # states (steps, lanes, 12)
            f"{what}: scan ({b}, {data.shape[1]}) x {v._ov_idx.shape[0]} steps",
        )
    c = checks["sponge_rows"]
    pi = rand(lanes, tpl.n_pi)
    want = th.sponge_rows_plain(pi, tpl.n_pi, consts)
    for b, part in zip(batches, parts):
        c.compare(th.sponge_rows(pi[part], tpl.n_pi, consts), want[part], f"{what}: public inputs ({b}, {tpl.n_pi})")
    widths = list(tpl.oracle_widths) + [2 << st["arity_bits"] for st in tpl.steps]
    group = [rand(lanes, Q, w) for w in widths]
    want = th.sponge_rows_grouped_plain(group, consts)
    for b, part in zip(batches, parts):
        for w, got, plain in zip(widths, th.sponge_rows_grouped([rows[part] for rows in group], consts), want):
            c.compare(got, plain[part], f"{what}: grouped ({b}, {Q}, {w})")
    c = checks["merkle_fold"]
    oracles = len(tpl.oracle_widths)
    paths = [((oracles, Q), tpl.initial_path_len)] + [((Q,), st["path_len"]) for st in tpl.steps]
    for lead, L in paths:
        if L == 0:
            continue
        dig, sib = rand(lanes, *lead, 4), rand(lanes, *lead, L, 4)
        idx = torch.from_numpy(rng.integers(0, 1 << 32, size=(lanes,) + lead, dtype=np.int64)).to(dev)
        want = th.merkle_fold_plain(dig, idx, sib, L, consts)
        for b, part in zip(batches, parts):
            c.compare(th.merkle_fold(dig[part], idx[part], sib[part], L, consts), want[part], f"{what}: walk {(b,) + lead}, L={L}")
    field = hold_field_kernels(v, batches, parts, checks, what, rng, queries)
    print(f"held against plain, {what} at batch {' and '.join(map(str, batches))}, {Q} queries: scan (batch, {data.shape[1]}) x {v._ov_idx.shape[0]}, "
          f"public inputs {tpl.n_pi}, grouped widths {widths}, walks {[('batch',) + lead + (L,) for lead, L in paths if L]}, "
          f"field calls (shapes after the batch axis) {field}: bit-exact in {time.time() - t:.1f} s")


def time_kernels(lib, consts, v, dev, checks, rate, zoo_tpl):
    """Kernel and plain times at the main path's shapes, each pair also held
    bit-exact against each other, each beside its bound; returns, per kernel,
    the times of its largest main-path call and prints every shape. The
    grouped sponge launch is timed at the main path's six matrices and at
    those of `zoo_tpl`, the second path's template."""
    import torch

    from plonky2_verifier_tpu_torch.ops import field as tf
    from plonky2_verifier_tpu_torch.ops import hash as th
    from plonky2_verifier_tpu_torch.ops import poseidon as tp
    from plonky2_verifier_tpu_torch.kernels import INV_GROUP, horner_segments
    from plonky2_verifier_tpu_torch.tools.bench_poseidon import device_ms, event_ms
    from plonky2_verifier_tpu_torch.tools.check_field_kernels import horner_rows_plain
    from plonky2_verifier_tpu_torch.tools.check_hash_kernels import rand_words

    rng = np.random.default_rng(7)
    tpl = v.tpl
    B, Q = BATCH, tpl.num_queries

    def timed(name, what, kernel, plain, iters, bound, work: str, plain_iters=2, words=None):
        """`words` turns an output into the tensor compared (the kernel's call is timed as it is)."""
        both = [kernel(), plain()]
        if words is not None:
            both = [words(x) for x in both]
        checks[name].compare(*(torch.stack(x) if isinstance(x, tuple) else x for x in both), what)
        ms, plain_ms = event_ms(kernel, iters, 2), event_ms(plain, plain_iters, plain_iters - 1)
        dev_ms = device_ms(kernel, iters, 1)  # the launches back to back: without the host's time to make each
        b_ms, by = bound
        print(f"time {name} {what}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; {work}), "
              f"share of bound {b_ms / ms:.3f} (device {b_ms / dev_ms:.3f})")
        return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}

    def measure(name, what, kernel, plain, iters, permutations, n_bytes, plain_iters=2):
        work = f"{permutations} permutations, {n_bytes} bytes = {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms"
        return timed(name, what, kernel, plain, iters, bound_ms(permutations, n_bytes, rate), work, plain_iters)

    out = {}
    # the transcript scan on the main path's own data and schedule
    data = v._transcript_data(dev, torch.zeros_like(dev["circuit_digest"])).contiguous()
    ov_idx, ov_mask = v._ov_idx, v._ov_mask
    n_perms = ov_idx.shape[0]
    scan_bytes = data.numel() * 8 + ov_idx.numel() * 9 + n_perms * B * 96
    out["permutation"] = measure(
        "permutation", f"scan ({B}, {data.shape[1]}) x {n_perms} steps",
        lambda: lib.permutation_scan(data, ov_idx, ov_mask), lambda: tp.permutation_scan_plain(data, ov_idx, ov_mask, consts),
        20, n_perms * B, scan_bytes, plain_iters=1,
    )
    for form in ("thread", "split"):
        checks["permutation"].compare(lib.permutation_scan(data, ov_idx, ov_mask, form), lib.permutation_scan(data, ov_idx, ov_mask), f"scan form {form}")
        print(f"time permutation scan ({B}) form {form}: {event_ms(lambda: lib.permutation_scan(data, ov_idx, ov_mask, form), 10, 2):.4f} ms")

    # one step, in both forms and as the launcher picks
    for n in STEP_SIZES:
        x = tf.from_u64(rand_words(rng, (n, 12)), "cuda")
        if n == B:
            out["permutation"]["step"] = measure("permutation", f"({n}, 12)", lambda: lib.permutation(x), lambda: tp.permutation_plain(x, consts), 200, n, n * 192)
        forms = {form: event_ms(lambda: lib.permutation(x, form), 200, 5) for form in ("thread", "split", "auto")}
        print(f"time permutation step n={n}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in forms.items())
              + f", bound {bound_ms(n, n * 192, rate)[0]:.5f} ms")

    def leaf_shapes(t):
        return [(B * t.num_queries, w) for w in t.oracle_widths] + [(B * t.num_queries, 2 << st["arity_bits"]) for st in t.steps]

    for n, w in [(B, tpl.n_pi)] + leaf_shapes(tpl):
        rows = tf.from_u64(rand_words(rng, (n, w)), "cuda")
        res = measure("sponge_rows", f"({n}, {w})", lambda: lib.sponge_rows(rows, w), lambda: th.sponge_rows_plain(rows, w, consts), 20, n * -(-w // 8), n * (w + 4) * 8)
        if w == max(tpl.oracle_widths):
            widest = res
    # every leaf hash of one verifier call in one launch, beside one launch a matrix
    for name, t in [("the main path", tpl), ("the gate-zoo path", zoo_tpl)]:
        shapes = leaf_shapes(t)
        group = [tf.from_u64(rand_words(rng, shape), "cuda") for shape in shapes]
        res = measure(
            "sponge_rows", f"grouped, {name}: {shapes}",
            lambda: torch.cat(lib.sponge_rows_grouped(group)), lambda: torch.cat(th.sponge_rows_grouped_plain(group, consts)),
            20, sum(n * -(-w // 8) for n, w in shapes), sum(n * (w + 4) * 8 for n, w in shapes), plain_iters=1,
        )
        apart = event_ms(lambda: [lib.sponge_rows(rows, rows.shape[1]) for rows in group], 20, 2)
        print(f"time sponge_rows grouped, {name}: the same matrices one launch each {apart:.4f} ms")
        if t is tpl:
            out["sponge_rows"] = dict(res, widest=widest)

    paths = [(B * 4 * Q, tpl.initial_path_len)] + [(B * Q, st["path_len"]) for st in tpl.steps]
    for n, L in paths:
        dig = tf.from_u64(rand_words(rng, (n, 4)), "cuda")
        idx = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.int64)).cuda()
        sib = tf.from_u64(rand_words(rng, (n, L, 4)), "cuda")
        res = measure("merkle_fold", f"({n}, L={L})", lambda: lib.merkle_fold(dig, idx, sib), lambda: th.merkle_fold_plain(dig, idx, sib, L, consts), 20, n * L, n * (72 + 32 * L))
        if L == tpl.initial_path_len:
            out["merkle_fold"] = res

    # the Horner sum on the arguments of every launch of one main-path call;
    # its row is its largest call (combineInitial's g0)
    largest = -1
    for name, args, _ in recorded_calls([(lib, "horner")], v, dev):
        v_re, v_im, p_re, p_im, v_rep, p_rep = args
        what = (f"({v_re.shape[0]} x {v_rep} rows, {v_re.shape[1]}) {'base' if v_im is None else 'ext'} values, "
                f"{'base' if p_im is None else 'ext'} point x {p_rep}, "
                f"{horner_segments(v_re.shape[0] * v_rep, v_re.shape[1], lib.sms)} segments a row")
        instructions, n_bytes = horner_work(args)
        size = v_re.shape[0] * v_rep * v_re.shape[1]
        work = f"{instructions} int32 instructions, {n_bytes} bytes = {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms"
        res = timed(name, what, lambda args=args: lib.horner(*args), lambda args=args: horner_rows_plain(*args), 20,
                    field_bound_ms(instructions, n_bytes, rate), work, plain_iters=1)
        if size >= largest:
            largest, out[name] = size, res

    # the grouped inversion: every denominator of one main-path call in its one
    # launch, beside the same words one launch a denominator (the form before
    # it was grouped) and the wrapper's call (concatenation, launch, split)
    ((_, (parts,), _),) = recorded_calls([(tf, "inv_grouped")], v, dev)
    flat = torch.cat([x.reshape(-1) for x in parts])
    instructions, n_bytes, kernel_instructions = inv_grouped_work(flat.numel())
    work = (f"{instructions} int32 instructions (3 (n - 1) + {INV_PRODUCTS} products; the kernel's {INV_PRODUCTS} a group of "
            f"{INV_GROUP} and 3 a word past its first {kernel_instructions}, the one-call kernel's {INV_PRODUCTS} a word "
            f"{flat.numel() * INV_PRODUCTS * PRODUCT}), {n_bytes} bytes = {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    out["inv"] = timed("inv", f"grouped: {flat.numel()} words, the denominators {[tuple(x.shape) for x in parts]}", lambda: lib.inv_grouped(flat),
                       lambda: tf.inv_plain(flat), 20, field_bound_ms(instructions, n_bytes, rate), work, plain_iters=1)
    contiguous = [x.contiguous() for x in parts]
    apart = lambda: [lib.inv(x) for x in contiguous]
    out["inv"]["apart"] = {"ms": event_ms(apart, 20, 2), "device_ms": device_ms(apart, 20, 1), "launches": len(parts)}
    out["inv"]["wrapper_ms"] = event_ms(lambda: tf.inv_grouped(parts), 20, 2)
    print(f"time inv grouped: the same denominators one launch each (the one-call kernel) {out['inv']['apart']['ms']:.4f} ms "
          f"(device {out['inv']['apart']['device_ms']:.4f} ms) in {len(parts)} launches; ops/field.inv_grouped's call "
          f"(concatenation, launch, split) {out['inv']['wrapper_ms']:.4f} ms")

    # the exponentiations and the gate program at every call of one verifier
    # call on random proof words, the main path's and the gate zoo's at the
    # same batch; a kernel's row is the main path's largest call, the zoo's
    # largest beside it
    from plonky2_verifier_tpu_torch import verifier_torch as vt
    from plonky2_verifier_tpu_torch.compiler.gates_torch import GateProgram, step_barriers
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    zoo_v = TorchVerifier(zoo_tpl, device=DEVICE)
    zoo_dev = zoo_v.prepare(random_arrays(zoo_tpl, B, zoo_tpl.num_queries, rng))
    pair = lambda x: (x.re, x.im) if isinstance(x, tf.GExt) else x
    targets = [(tf, "pow_grouped"), (GateProgram, "forward"), (vt, "coset_folds"), (vt, "partial_products"), (vt, "lookup_checks"),
               (vt, "gate_filter")]
    # the three stages' kernels: their wrapper's call beside their plain version
    stages = {"coset_folds": ("coset_fold", fold_work, vt.coset_folds_plain),
              "partial_products": ("partial_products", partial_products_work, vt.partial_products_plain),
              "lookup_checks": ("lookup_checks", lookup_work, vt.lookup_checks_plain),
              "gate_filter": ("gate_filter", gate_filter_work, vt.gate_filter_plain)}
    for path, verifier, arrays in [("main path", v, dev), ("gate zoo", zoo_v, zoo_dev)]:
        largest = {}
        for name, args, kwargs in recorded_calls(targets, verifier, arrays):
            if name == "forward":
                name, (prog, inputs, batch_shape) = "gate_program", args
                packed = kwargs["packed"]  # the verifier's program packed for its gather
                instructions, n_bytes = gate_work(packed, inputs)
                plan = lib.gate_plan(batch_shape[0], packed)
                what = (f"{path}: {prog.n_levels} levels, {prog.n_tape} slots; packed {packed.n_steps} steps, {packed.n_slots} slots, "
                        f"{plan['lanes']} lanes and {plan['threads']} threads a block, {plan['form']} tapes, "
                        f"{'staged' if plan['staged'] else 'unstaged'} program, {step_barriers(packed.step_off.cpu().numpy(), plan['lanes'])} block barriers; "
                        f"{packed.n_adds} adds and {packed.n_muls} multiplies a lane, {batch_shape[0]} lanes")
                kernel = lambda prog=prog, args=args, kwargs=kwargs: pair(prog(*args[1:], **kwargs))
                plain = lambda prog=prog, args=args, kwargs=kwargs: pair(prog.forward_plain(*args[1:], out_slots=kwargs.get("out_slots")))
                size = instructions
            elif name in stages:
                kernel = lambda fn=getattr(vt, name), args=args, kwargs=kwargs: fn(*args, **kwargs)
                name, work_of, plain_fn = stages[name]
                instructions, n_bytes, what, *_ = work_of(*args)
                what, size = f"{path}: {what}", instructions
                plain = lambda fn=plain_fn, args=args: fn(*args)
            else:
                instructions, n_bytes, what, before = pow_grouped_work(*args)
                what, size = f"{path}: {what}", instructions
                kernel = lambda args=args: tf.pow_grouped(*args)
                plain = lambda args=args: tf.pow_grouped_plain(*args)
                name = "pow"
            work = f"{instructions} int32 instructions, {n_bytes} bytes = {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms"
            if name == "pow":
                work += f"; {before} instructions before the table (n_bits - 1 squarings a generator)"
            res = timed(name, what, kernel, plain, 20, field_bound_ms(instructions, n_bytes, rate), work, plain_iters=1,
                        words=words_of if name in ("pow", "coset_fold", "partial_products", "lookup_checks", "gate_filter") else None)
            if name == "pow":  # beside one launch of the one-call kernel a power, as before they were grouped
                apart = powers_apart(*args)
                res["apart"] = {"ms": event_ms(apart, 20, 2), "device_ms": device_ms(apart, 20, 1), "launches": len(apart())}
                print(f"time pow grouped, {path}: the same powers one launch each (the one-call kernel) {res['apart']['ms']:.4f} ms "
                      f"(device {res['apart']['device_ms']:.4f} ms) in {res['apart']['launches']} launches")
            if size >= largest.get(name, -1):
                largest[name] = size
                if path == "main path" or name not in out:  # the lookup argument: the gate zoo's alone (fibonacci has none)
                    out[name] = dict(res, timed_on=path)
                else:
                    out[name]["zoo"] = res
    return out


def output_tensors(x):
    """An output (a tensor, a GExt, lists and tuples of them) as a list of
    tensors, each with the batch axis first (a GExt's parts stacked after it)."""
    import torch

    from plonky2_verifier_tpu_torch.ops import field as tf

    if isinstance(x, (list, tuple)):
        return [t for y in x for t in output_tensors(y)]
    return [torch.stack([x.re, x.im], dim=1)] if isinstance(x, tf.GExt) else [x]


def words_of(x):
    """Every word of an output as one flat tensor."""
    import torch

    return torch.cat([t.reshape(-1) for t in output_tensors(x)])


def powers_apart(qidx, gens, exts):
    """pow_grouped's powers as the one-call kernel made them before they were
    grouped: a launch of ops/field.pow_dynamic a generator (its exponents
    made here, outside the timed call) and of ext_pow_const a base."""
    from plonky2_verifier_tpu_torch.ops import field as tf

    exps = [(tf.constant(g.generator, (1, 1), qidx.device).expand(qidx.shape), g.exponent(qidx), max(g.bits, 1)) for g in gens]
    return lambda: [tf.pow_dynamic(*x) for x in exps] + [tf.ext_pow_const(base, e) for base, e in exts if e >= 2]


def pow_grouped_work(qidx, gens, exts):
    """(int32 instructions, bytes, description, the instructions that the
    one-call kernel's square-and-multiply needed) of one grouped
    exponentiation, the least that the function needs: a fixed-generator
    element is the factor times a product of table entries g^(d 2^(w k)),
    one a POW_WINDOW-bit window of its exponent (tables of 2^POW_WINDOW
    words a window, read once; wider windows need fewer products still, and
    the bytes set the bound from 4-bit windows up), and an extension row's
    square-and-multiply, an emul a product, where its exponent is at least 2
    (0 and 1 launch nothing); the query indices and every base word read
    once, each output written once. The kernel reads g^(2^k) and makes a
    product a set bit."""
    windows = sum(-(-g.bits // POW_WINDOW) for g in gens)
    launched = [(base.re.numel(), e) for base, e in exts if e >= 2]
    emuls = sum(rows * (e.bit_length() - 1 + bin(e).count("1")) for rows, e in launched)
    n = qidx.numel()
    words = n + windows * (1 << POW_WINDOW) + len(gens) * n + sum(4 * rows for rows, _ in launched)
    ones = sum(sum(int(((g.exponent(qidx) >> k) & 1).sum()) for k in range(g.bits)) for g in gens)
    squarings = sum(max(g.bits, 1) - 1 for g in gens)  # a broadcast generator's, once each
    what = (f"pow_grouped {tuple(qidx.shape)}: {len(gens)} generators of {[g.bits for g in gens]} bits, "
            f"{len(launched)} extension bases at e = {[e for _, e in launched]}; the kernel's table products "
            f"{ones * PRODUCT + emuls * EMUL} instructions")
    return (windows * n * PRODUCT + emuls * EMUL, 8 * words, what, (ones + squarings) * PRODUCT + emuls * EMUL)


def inv_grouped_work(n: int):
    """(int32 instructions, bytes, the kernel's own instructions) of one
    grouped inversion of n words. The least work is Montgomery's batch trick
    over all n words: 3 (n - 1) products (a prefix product, two in the sweep
    back) and one Fermat chain of INV_PRODUCTS; each word read once and
    written once. The kernel runs a chain a group of INV_GROUP words, its
    own choice: INV_PRODUCTS a group and 3 a word past a group's first."""
    from plonky2_verifier_tpu_torch.kernels import INV_GROUP

    groups = -(-n // INV_GROUP)
    least = (3 * max(n - 1, 0) + INV_PRODUCTS) * PRODUCT if n else 0
    return least, 16 * n, (INV_PRODUCTS * groups + 3 * (n - groups)) * PRODUCT


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


def partial_products_work(zeta_n, l0_den_inv, zs, zs_next, pps, wires, sigmas, betas, gammas, zeta, k_is, maxdeg, *, weights=None,
                          lanes=None):
    """(int32 instructions, bytes, description, the kernel's instructions)
    of one partial_products launch. The least the function needs: beta
    zeta a round (2 products); a wire's numerator term k_i times it (2) and
    3 adds, its denominator term an escale of sigma (2) and 3 adds, a round;
    a chunk's two products maxdeg - 1 emuls each, two emuls by the current
    values and a subtraction; L0 an emul a lane and one a round, with their
    subtractions; each opening and challenge word read once, each output
    written once. The kernel (csrc/plonk.cu; L lanes a chunk,
    kernels.partial_products_lanes unless `lanes`) runs on every lane of a
    chunk's group, padding lanes too: beta zeta (2 products), ceil(maxdeg /
    L) wires' terms (four products, each added to its words and reduced
    once: goldilocks.cuh's mul_add), the chain of a lane's further wires (2
    emuls a wire), log2 L tree levels of one emul and the last emul (L = 1:
    the two), a subtraction (2 subs); a thread a (b, round) L0's 2 emuls and
    4 subs. `weights`: the instructions of "mul", "mul_add" (a b + c),
    "mul_add2" (a b + c + d), "emul" (each part reduced once) and "sub" the
    kernel's ops are counted at, W's reckoning unless given (a product
    PRODUCT, an add ADD, an emul EMUL); the least is W's always."""
    from plonky2_verifier_tpu_torch.kernels import partial_products_lanes

    B, r = zs.shape
    ns = sigmas.shape[1]
    n_chunks = ns // maxdeg
    instructions = (B * r * 2 * PRODUCT + B * r * ns * (4 * PRODUCT + 6 * ADD) + B * r * n_chunks * (2 * maxdeg * EMUL + 2 * ADD)
                    + B * (EMUL + 2 * ADD) + B * r * (EMUL + 2 * ADD))
    n_words = 6 * B + 4 * B * r + 2 * pps.re.numel() + 4 * B * ns + 2 * B * r + ns + 2 * B * (r + r * n_chunks)
    w = weights or {"mul": PRODUCT, "mul_add": PRODUCT + ADD, "mul_add2": PRODUCT + 2 * ADD, "emul": EMUL, "sub": ADD}
    L = lanes or partial_products_lanes(maxdeg)
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
    from plonky2_verifier_tpu_torch.kernels import lookup_split

    emul = 5 * product + 2 * add
    B, r = wires.shape[0], len(deltas)
    n_polys = lookup_zs.shape[1] // r
    n_sldc, num_lu, num_lut = n_polys - 1, num_routed_wires // 2, num_routed_wires // 3
    rows, luts = coeffs.shape[0], offsets.numel() - 1
    slot = 2 * product + 4 * add
    slots = num_lu * (slot + 2 * emul + 2 * add) + num_lut * (slot + 3 * emul + 2 * add)
    equations = n_sldc * (4 * emul + 6 * add) + 2 * add + emul + luts * (product + 3 * add + emul) + 3 * emul
    per_round = slots + equations + num_lut * (4 * product + 4 * add) + rows * 2 * (product + add)
    chunk, re_lanes, table_lanes = lookup_split(num_routed_wires, n_sldc, maxdeg, offsets.tolist())
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
    from plonky2_verifier_tpu_torch.kernels import GATE_FILTER_LANES, GATE_FILTER_MAX_LIVE

    B, L = cons.shape[0], cols.shape[0]
    lanes = min(GATE_FILTER_LANES, GATE_FILTER_MAX_LIVE // max(L, 1))
    factors = [int(x) for x in mask.sum(dim=1)]
    per_lane = sum(2 * ADD * f + EMUL * max(f - 1, 0) for f in factors)
    instructions = B * (L * n_gc * (EMUL + 2 * ADD) + per_lane)
    n_words = 2 * B * len(set(cols.tolist())) + 2 * B * L * n_gc + 2 * B * n_gc + L + consts.numel()
    what = (f"gate_filter: {B} lanes, {L} live gates of {n_gc} constraints, {sum(factors)} live factors in rows of {consts.shape[1]} slots, "
            f"{lanes} lanes a block")
    return instructions, 8 * n_words + mask.numel(), what


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


def _transcript_equals_golden(common, dbg, lane, vkey, pwp):
    from plonky2_verifier_tpu_torch.golden.challenges import proof_challenges
    from plonky2_verifier_tpu_torch.golden.hashing import sponge
    from plonky2_verifier_tpu_torch.ops.field import to_u64

    ch = proof_challenges(common, vkey, pwp)
    u = lambda t: [int(v) for v in np.atleast_1d(to_u64(t[lane]))]
    got = {
        "zeta": (u(dbg["zeta"][0])[0], u(dbg["zeta"][1])[0]),
        "betas": [u(b)[0] for b in dbg["betas"]],
        "gammas": [u(g)[0] for g in dbg["gammas"]],
        "alphas": [u(a)[0] for a in dbg["alphas"]],
        "deltas": [tuple(u(x)[0] for x in d) for d in dbg["deltas"]],
        "fri_alpha": (u(dbg["fri_alpha"][0])[0], u(dbg["fri_alpha"][1])[0]),
        "pow_response": u(dbg["pow_response"])[0],
        "query_indices": u(dbg["query_indices"]),
        "pi_hash": tuple(u(dbg["pi_hash"])),
    }
    want = {
        "zeta": tuple(ch.zeta),
        "betas": list(ch.betas),
        "gammas": list(ch.gammas),
        "alphas": list(ch.alphas),
        "deltas": [(d.a, d.b, d.alpha, d.delta) for d in ch.deltas],
        "fri_alpha": tuple(ch.fri.alpha),
        "pow_response": ch.fri.pow_response,
        "query_indices": list(ch.fri.query_indices),
        "pi_hash": tuple(sponge(pwp.public_inputs)),
    }
    for k in want:
        if got[k] != want[k]:
            raise AssertionError(f"lane {lane}: {k} differs from golden: {got[k]} != {want[k]}")


def _field_launches(tpl) -> dict:
    """Field-kernel launches a verifier call of `tpl`: the Horner sum for
    the alpha combination, the quotient, the two reduced openings,
    combineInitial's two sums and the final polynomial; one grouped launch
    for every inversion (L0, combineInitial's two quotients, each fold
    step's coset offset) and one for every exponentiation (combineInitial's
    query points, each fold step's coset offset, the final x, zeta^n and
    alpha^(n_zs + n_lookup)); the one-call inversion and exponentiation
    never; the gate program once; every fold step's coset fold in one
    launch (none without fold steps); L0 with the partial products once;
    the lookup argument once where the template has lookups, else never;
    the gate filter once where a gate has constraints."""
    return {"horner": 7, "inv": 0, "inv_grouped": 1, "pow": 0, "pow_grouped": 1, "gate_program": 1, "coset_fold": 1 if tpl.steps else 0,
            "partial_products": 1, "lookup_checks": 1 if tpl.common.num_lookup_polys > 0 else 0,
            "gate_filter": 1 if tpl.common.num_gate_constraints > 0 else 0}


FIELD_KERNELS = ("horner", "inv", "inv_grouped", "pow", "pow_grouped", "gate_program", "coset_fold", "partial_products", "lookup_checks",
                 "gate_filter")


def _check_launches(launches, what: str, tpl):
    """The scan once, the Merkle walk at least once, the sponge twice (the
    public-input hash and one grouped launch for every leaf hash), and the
    field kernels exactly as _field_launches counts them."""
    if launches["permutation_scan"] < 1 or launches["merkle_fold"] <= 0:
        raise AssertionError(f"a kernel was not launched on {what}: {launches}")
    if (launches["sponge_rows"], launches["sponge_rows_grouped"]) != (1, 1):
        raise AssertionError(f"{what} should launch the sponge twice (one matrix, one group): {launches}")
    field = _field_launches(tpl)
    if {k: launches[k] for k in field} != field:
        raise AssertionError(f"{what} should launch the field kernels {field}: {launches}")


def _check_mutations(tpl, arrays, batch: int, names):
    """Lane k gets one u64 of array names[k] flipped (a (name, column) pair
    flips that column's first word; bench.fault_lanes); exactly those lanes
    must be rejected, through the one-call entry point."""
    from plonky2_verifier_tpu_torch.bench import fault_lanes
    from plonky2_verifier_tpu_torch.verifier_torch import verify_batch

    out_m = verify_batch(tpl, fault_lanes(arrays, batch, list(enumerate(names))), device=DEVICE)["ok"]
    rejected = sorted(int(i) for i in np.flatnonzero(~out_m))
    print(f"mutations {names}: rejected lanes {rejected}")
    if rejected != list(range(len(names))):
        raise AssertionError("mutated lanes are not exactly the rejected ones")


def main_path(lib, checks):
    import torch

    from plonky2_verifier_tpu_torch.bench import FAULTED
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.metrics import perms_per_proof
    from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
    from plonky2_verifier_tpu_torch.models.fibonacci import fibonacci_fixture
    from plonky2_verifier_tpu_torch.prover.prove import prove
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    t = time.time()
    common, vkey, pwp = get_fixture_proof("fibonacci", **STANDARD)
    tpl = CircuitTemplate(common)
    print(f"fixture: {time.time() - t:.1f} s (degree_bits {tpl.degree_bits}, {tpl.num_queries} queries, PoW {tpl.pow_bits}, "
          f"{perms_per_proof(tpl)} permutations a proof)")
    if STANDARD["n_arith_rows"] == 4093 and perms_per_proof(tpl) != 2774:
        raise AssertionError(f"the standard shape should count 2,774 permutations a proof, not {perms_per_proof(tpl)}")
    t = time.time()
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * BATCH)
    print(f"flatten_proofs x{BATCH}: {time.time() - t:.1f} s, {sum(a.nbytes for a in arrays.values())} bytes")

    v = TorchVerifier(tpl, debug=True, device=DEVICE)
    dev = v.prepare(arrays)
    torch.cuda.synchronize()

    lib.reset_launches()
    t = time.time()
    out = v(dev)
    torch.cuda.synchronize()
    first_s = time.time() - t
    launches = dict(lib.launches)
    print(f"main path: first call {first_s:.3f} s, launches {launches}")
    n_ok = int(out["ok"].sum())
    print(f"accepted {n_ok}/{BATCH} (eqs_ok {int(out['eqs_ok'].sum())}, fri_ok {int(out['fri_ok'].sum())})")
    if n_ok != BATCH:
        raise AssertionError("standard batch not fully accepted")
    _check_launches(launches, "the main path", tpl)
    _transcript_equals_golden(common, out["debug"], 0, vkey, pwp)
    print("lane 0 transcript equals golden")
    _check_mutations(tpl, arrays, BATCH, list(FAULTED))

    fx0 = fibonacci_fixture(num_query_rounds=6)
    tpl6 = CircuitTemplate(fx0.common)
    lanes = [prove(fibonacci_fixture(num_query_rounds=6, x0=a, x1=b)) for a, b in [(1, 2), (3, 5), (10, 11), (7, 1)]]
    v6 = TorchVerifier(tpl6, debug=True, device=DEVICE)
    out6 = v6(v6.prepare(flatten_proofs(tpl6, lanes)))
    if not bool(out6["ok"].all()):
        raise AssertionError(f"heterogeneous batch rejected: {out6['ok']}")
    for lane, (vk, pw) in enumerate(lanes):
        _transcript_equals_golden(fx0.common, out6["debug"], lane, vk, pw)
    print("heterogeneous 4-lane batch accepted; every lane's transcript equals golden")
    hold_against_plain(v6, len(lanes), checks, "the heterogeneous batch")
    return v, dev, launches, (tpl, common, vkey, pwp)


def time_main_path(v, dev, batch: int, iters: int, warmup: int = 2):
    """bench.time_calls, the benchmark's own timing: `iters` calls, each
    until its verdict is on the host, after `warmup`; returns the median
    step in seconds."""
    import torch

    from plonky2_verifier_tpu_torch.bench import step_stats, time_calls
    from plonky2_verifier_tpu_torch.tools.bench_poseidon import event_ms

    timed = time_calls(v, dev, iters, warmup)
    if not timed["all_verified"]:
        raise AssertionError("timed batch not fully accepted")
    stats = step_stats(timed["steps_s"])
    step = stats["step_ms_median"] / 1e3
    print(f"step_ms {step * 1e3:.3f} (the median of {iters} calls; min {stats['step_ms_min']:.3f}, max {stats['step_ms_max']:.3f})")
    print(f"proofs_per_s {batch / step:.1f}")
    print(f"batch {batch}")

    # transcript alone (one scan launch plus the slicing of its states)
    pi_hash = torch.zeros_like(dev["circuit_digest"])
    data = v._transcript_data(dev, pi_hash)
    print(f"transcript_ms {event_ms(lambda: v._run_transcript(data), 20, 2):.3f}")
    return step


def bench_once(smi: str, main_launches: dict):
    """`python3 bench_torch.py` once, in a process of its own, on the
    standard fixture this run proved and the kernels it built, BENCH_ITERS
    calls at BATCH: exit 0, one JSON line, every proof accepted, the seeded
    faults rejected on exactly their lanes, every kernel the main path
    launched launched by the bench too, and the card named as nvidia-smi
    names it. Returns the line."""
    from plonky2_verifier_tpu_torch import bench

    env = dict(os.environ, BENCH_MODE="batch", BENCH_MODEL="fibonacci", BENCH_BATCH=str(BATCH), BENCH_ITERS=str(BENCH_ITERS))
    for k in ("BENCH_DEGREE_BITS", "BENCH_QUERIES", "BENCH_POW_BITS"):
        env.pop(k, None)
    if bench.fixture_params(bench.settings(env)) != STANDARD:
        raise AssertionError(f"the bench's fixture {bench.fixture_params(bench.settings(env))} is not this run's {STANDARD}")
    t = time.time()
    res = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    if res.returncode != 0:
        raise RuntimeError(f"bench_torch.py exited {res.returncode}:\n{res.stdout}\n{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench_torch.py printed {len(lines)} lines, not one: {res.stdout[-2000:]}")
    line = json.loads(lines[0])
    print(f"bench_torch ({time.time() - t:.1f} s): {lines[0]}")
    if not (line["all_verified"] and line["faults_rejected"] and line["fault_lanes"] == line["rejected_lanes"] and line["fault_lanes"]):
        raise AssertionError(f"bench_torch.py's gate: all_verified {line['all_verified']}, faults {line['fault_lanes']}, "
                             f"rejected {line['rejected_lanes']}")
    if (line["step_count"], line["batch"], line["mode"]) != (BENCH_ITERS, BATCH, "batch"):
        raise AssertionError(f"bench_torch.py timed {line['step_count']} calls at batch {line['batch']} in mode {line['mode']}")
    missing = [k for k, n in main_launches.items() if n > 0 and not line["kernel_launches"][k] > 0]
    if missing:
        raise AssertionError(f"bench_torch.py never launched {missing}, which the main path launched: {line['kernel_launches']}")
    if line["device"] != smi:
        raise AssertionError(f"bench_torch.py names the device {line['device']!r}, nvidia-smi {smi!r}")
    return line


PROVER = """
import sys, time
sys.path.insert(0, {root!r})
from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof
t = time.time()
get_fixture_proof({name!r}, **{params!r})
print(f"{{time.time() - t:.1f}}")
"""


def start_prover(name: str, params: dict):
    """A child process that proves one fixture into the fixture cache while
    this process builds and checks the kernels."""
    code = PROVER.format(root=ROOT, name=name, params=params)
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_for_prover(prover, what: str):
    t = time.time()
    out, err = prover.communicate()
    if prover.returncode != 0:
        raise RuntimeError(f"proving the {what} fixture failed ({prover.returncode}):\n{err}")
    print(f"{what} fixture: proved (or found cached) in {out.strip()} s by a child process, waited {time.time() - t:.1f} s for it")


def zoo_fixture(prover=None):
    """The gate-zoo template and proof; waits for `prover` first, if given."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
    from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof

    if prover is not None:
        wait_for_prover(prover, "gate zoo")
    t = time.time()
    common, vkey, pwp = get_fixture_proof("gate_zoo", **ZOO)
    tpl = CircuitTemplate(common)
    print(f"gate zoo fixture: {time.time() - t:.1f} s (degree_bits {tpl.degree_bits}, {tpl.num_queries} queries, PoW {tpl.pow_bits}, "
          f"{tpl.num_wires} wires, {len(common.gates)} gates of {len({g.kind for g in common.gates})} kinds, {tpl.n_lookup} lookup openings, "
          f"oracle widths {tpl.oracle_widths})")
    if tpl.n_lookup == 0:
        raise AssertionError("the gate-zoo fixture has no lookups")
    return tpl, common, vkey, pwp


def zoo_path(lib, zoo, checks):
    """The second path: the gate-zoo template with lookups through
    TorchVerifier at each batch of ZOO_BATCHES, the kernels then held against
    their plain versions at that batch's shapes. Returns the launch counts of
    each batch's first call."""
    import torch

    from plonky2_verifier_tpu_torch.bench import FAULTED, lookup_opening_column
    from plonky2_verifier_tpu_torch.compiler import flatten_proofs
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    tpl, common, vkey, pwp = zoo
    # one u64 flipped in each array, and a lookup opening inside openings1
    names = list(FAULTED) + [("openings1", lookup_opening_column(tpl))]
    v = TorchVerifier(tpl, debug=True, device=DEVICE)
    counts = {}
    for batch in ZOO_BATCHES:
        arrays = flatten_proofs(tpl, [(vkey, pwp)] * batch)
        dev = v.prepare(arrays)
        torch.cuda.synchronize()
        lib.reset_launches()
        t = time.time()
        out = v(dev)
        torch.cuda.synchronize()
        first_s = time.time() - t
        counts[batch] = launches = dict(lib.launches)
        print(f"gate zoo batch {batch}: first call {first_s:.3f} s, launches {launches}")
        n_ok = int(out["ok"].sum())
        print(f"gate zoo batch {batch}: accepted {n_ok}/{batch} (eqs_ok {int(out['eqs_ok'].sum())}, fri_ok {int(out['fri_ok'].sum())})")
        if n_ok != batch:
            raise AssertionError(f"gate-zoo batch {batch} not fully accepted")
        _check_launches(launches, f"the gate-zoo path at batch {batch}", tpl)
        _transcript_equals_golden(common, out["debug"], 0, vkey, pwp)
        print(f"gate zoo batch {batch}: lane 0 transcript equals golden")
        _check_mutations(tpl, arrays, batch, names)
        hold_against_plain(v, batch, checks, "the gate-zoo path")
        if ZOO_TIMED_CALLS:
            print(f"gate zoo batch {batch} timing:")
            time_main_path(v, dev, batch, ZOO_TIMED_CALLS, warmup=1)
        del dev, arrays
    return counts


def ingest_phase(fixture):
    """The native ingest must be the tier that runs here, and must equal
    flatten_proofs with one worker and with several (tools/bench_ingest.py
    asserts it); prints its times."""
    from plonky2_verifier_tpu_torch import native
    from plonky2_verifier_tpu_torch.tools.bench_ingest import bench

    tpl, _, vkey, pwp = fixture
    t = time.time()
    if native.get_fastload() is None:
        raise RuntimeError(f"the native ingest did not build or load: {native.last_build_error}")
    print(f"ingest: native parser ready in {time.time() - t:.1f} s ({native._so_path()})")
    res = bench(tpl, vkey, pwp, INGEST_PROOFS)
    if "native_mt_ms_per_proof" not in res:
        raise AssertionError(f"the native ingest was not measured: {res}")
    print(f"ingest: {json.dumps(res)}")
    return res


def _merkle_launches(tpl) -> int:
    """Merkle launches a verifier call: the stacked initial walk and every
    fold step whose path is not empty."""
    return (1 if tpl.initial_path_len else 0) + sum(1 for st in tpl.steps if st["path_len"])


def stream_path(lib, fixture, step_s: float, ingest: dict):
    """The third path: raw JSON bytes -> native ingest -> pinned buffers ->
    the card -> TorchVerifier -> StreamMetrics. Returns the launch counts of
    the whole run and its final snapshot."""
    import torch

    from plonky2_verifier_tpu_torch import native
    from plonky2_verifier_tpu_torch.parallel.stream import StreamVerifier
    from plonky2_verifier_tpu_torch.tools.bench_poseidon import event_ms
    from plonky2_verifier_tpu_torch.tools.stream_verify import proof_stream

    tpl, _, vkey, pwp = fixture
    items, expected = proof_stream(vkey, pwp, STREAM_PROOFS, STREAM_CORRUPT_EVERY, raw=True)

    def refuse(*_):
        raise AssertionError("the stream fell to the Python ingest tier")

    python_tier, native._flatten_python = native._flatten_python, refuse
    try:
        sv = StreamVerifier(tpl, BATCH, raw_json=True, device=DEVICE)
        lib.reset_launches()
        m = sv.run(items, on_batch=lambda mm: print(f"stream: {mm.line()}", flush=True))
        torch.cuda.synchronize()
        launches = dict(lib.launches)
    finally:
        native._flatten_python = python_tier
    snap = m.snapshot()
    batches = -(-STREAM_PROOFS // BATCH)
    print(f"stream: final {json.dumps(snap)}")
    print(f"stream: launches {launches}, {sv.ingest_workers} ingest workers")
    got = (m.proofs, m.accepted, m.rejected, m.batches)
    if got != (STREAM_PROOFS, STREAM_PROOFS - expected, expected, batches):
        raise AssertionError(f"stream counted (proofs, accepted, rejected, batches) = {got}")
    want = {"permutation": 0, "permutation_scan": batches, "sponge_rows": batches,
            "sponge_rows_grouped": batches, "merkle_fold": batches * _merkle_launches(tpl),
            **{k: batches * n for k, n in _field_launches(tpl).items()}}
    if launches != want:
        raise AssertionError(f"stream launches {launches}, expected {want}")
    calls_s = snap["elapsed_s"] - m.ingest_s - m.device_wait_s
    hidden = 1 - m.ingest_s / sv.ingest_work_s
    per_batch = ingest["native_mt_ms_per_proof"] * BATCH / 1e3
    print(f"stream: {snap['proofs_per_sec']} proofs/s over all ({snap['steady_proofs_per_sec']} after the first batch); "
          f"first path's step {step_s * 1e3:.3f} ms -> {BATCH / step_s:.1f} proofs/s at {BATCH} / step, "
          f"{BATCH / (step_s + per_batch):.1f} at {BATCH} / (step + ingest of {per_batch * 1e3:.1f} ms a batch)")
    print(f"stream: ingest work {sv.ingest_work_s:.3f} s ({sv.ingest_work_s / STREAM_PROOFS * 1e3:.3f} ms a proof, beside the verifier "
          f"calls), of which the calling thread waited for ingest_s = {m.ingest_s:.3f} s: the prefetch hid {hidden:.3f} of it; "
          f"device_wait_s {m.device_wait_s:.3f} s; elapsed - ingest_s - device_wait_s = {calls_s:.3f} s")
    if m.ingest_s + m.device_wait_s > snap["elapsed_s"]:
        raise AssertionError(f"ingest_s + device_wait_s = {m.ingest_s + m.device_wait_s} exceeds elapsed_s = {snap['elapsed_s']}")
    if sv._staging is not None:  # a CPU rehearsal stages nothing
        pinned, on_card = sv._staging.pinned[0], sv._staging.on_card[0]
        copy_ms = event_ms(lambda: [on_card[k].copy_(pinned[k], non_blocking=True) for k in pinned], 5)
        print(f"stream: copy to the card {copy_ms:.3f} ms a batch ({sum(t.numel() * 8 for t in pinned.values())} bytes from the "
              f"stream's pinned set to its device set, 5 copies timed after the run)")
    return launches, snap


def cli_path(lib, fixtures, checks):
    """The command line in process: `stream` over a directory that holds one
    triple of each shape, then `verify` on the first triple, then the kernels
    held against their plain versions at each shape's CLI_BATCH shapes.
    Returns the launch counts of the `stream` command."""
    from plonky2_verifier_tpu_torch.__main__ import main as cli
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    device = [] if DEVICE is None else ["--device", DEVICE]
    with tempfile.TemporaryDirectory() as folder:
        for name, (_, common, vkey, pwp) in fixtures.items():
            for obj, kind in [(common, "common"), (vkey, "vkey"), (pwp, "proof")]:
                with open(os.path.join(folder, f"{name}_{kind}.json"), "w") as f:
                    json.dump(obj.to_json(), f)
        printed = io.StringIO()
        lib.reset_launches()
        t = time.time()
        with contextlib.redirect_stdout(printed):
            rc = cli(["stream", folder, "--batch", str(CLI_BATCH), "--repeat", str(CLI_REPEAT)] + device)
        launches = dict(lib.launches)
        lines = printed.getvalue().strip().splitlines()
        print("\n".join(f"cli stream: {line}" for line in lines))
        summary = json.loads(lines[-1])
        print(f"cli stream: exit code {rc}, {time.time() - t:.1f} s, launches {launches}")
        counts = sorted((m["proofs"], m["accepted"]) for m in summary["per_shape"].values())
        if rc != 0 or summary["shapes"] != len(fixtures) or counts != [(CLI_REPEAT, CLI_REPEAT)] * len(fixtures):
            raise AssertionError(f"cli stream: exit code {rc}, {summary}")
        calls = -(-CLI_REPEAT // CLI_BATCH)  # batches a shape
        want = {"permutation": 0, "permutation_scan": calls * len(fixtures), "sponge_rows": calls * len(fixtures),
                "sponge_rows_grouped": calls * len(fixtures), "merkle_fold": calls * sum(_merkle_launches(f[0]) for f in fixtures.values()),
                **{k: calls * sum(_field_launches(f[0])[k] for f in fixtures.values()) for k in FIELD_KERNELS}}
        if launches != want:
            raise AssertionError(f"cli stream: launches {launches}, expected {want}")
        rc = cli(["verify", os.path.join(folder, next(iter(fixtures))), "--batch", str(CLI_VERIFY_BATCH)] + device)
        if rc != 0:
            raise AssertionError(f"cli verify: exit code {rc}")
    for k, (name, fixture) in enumerate(fixtures.items()):
        if name == "gate_zoo" and CLI_BATCH in ZOO_BATCHES:
            continue  # zoo_path held this template at this batch
        v = TorchVerifier(fixture[0], device=DEVICE)
        # the first shape at verify's batch too
        hold_against_plain(v, [CLI_BATCH, CLI_VERIFY_BATCH] if k == 0 else CLI_BATCH, checks, f"the command line's stream{' and verify' if k == 0 else ''}, {name}")
    return launches


def check_circuit(name: str, common, vkey, pwp, faults):
    """One proof of a small circuit through TorchVerifier: a batch of 2 accepted with
    lane 0's transcript equal to golden, then a batch that holds one fault a
    lane (the first word of that array flipped; empty arrays passed over)
    and one intact lane behind them, rejected on exactly the faulted lanes.
    Returns the verifier and the sizes of the two batches."""
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate, flatten_proofs
    from plonky2_verifier_tpu_torch.verifier_torch import TorchVerifier

    tpl = CircuitTemplate(common)
    v = TorchVerifier(tpl, debug=True, device=DEVICE)
    out = v(v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * 2)))
    if v.to_host(out).tolist() != [True, True]:
        raise AssertionError(f"{name}: an honest proof was rejected: {out['ok']}, eqs {out['eqs_ok']}, fri {out['fri_ok']}")
    _transcript_equals_golden(common, out["debug"], 0, vkey, pwp)
    arrays = flatten_proofs(tpl, [(vkey, pwp)] * (len(faults) + 1))
    live = [f for f in faults if f in arrays and arrays[f].size]
    for lane, fault in enumerate(live):
        arrays[fault].reshape(len(faults) + 1, -1)[lane, 0] ^= np.uint64(1)
    ok = v.to_host(v(v.prepare({k: a[: len(live) + 1] for k, a in arrays.items()}))).tolist()
    if ok != [False] * len(live) + [True]:
        raise AssertionError(f"{name}: faults {live} gave verdicts {ok}")
    print(f"shape {name}: degree_bits {tpl.degree_bits}, cap {tpl.cap_len}, initial path {tpl.initial_path_len}, steps "
          f"{[(st['arity_bits'], st['path_len'], st['cap_len']) for st in tpl.steps]}, final poly {tpl.final_poly_len}, "
          f"{tpl.n_pi} public inputs, {tpl.num_queries} queries: accepted, transcript equals golden, rejected {live}")
    return v, [2, len(live) + 1]


def shapes_path(lib, checks):
    """Shape variety: the grid points and the fuzz circuits of
    tools/shape_circuits.py, each through check_circuit, the kernels then
    held against their plain versions at each circuit's shapes at both of
    its batch sizes. Returns the launch counts of the verifier calls."""
    from plonky2_verifier_tpu_torch.prover.prove import prove
    from plonky2_verifier_tpu_torch.tools import shape_circuits as sc

    lib.reset_launches()
    t = time.time()
    circuits = [(f"grid {pt}", sc.grid_fixture(*pt), sc.GRID_FAULTS) for pt in sc.GRID]
    circuits += [(f"fuzz {seed}", sc.fuzz_fixture(seed), sc.FUZZ_FAULTS) for seed in sc.FUZZ_SEEDS]
    ran = [check_circuit(name, fx.common, *prove(fx), faults) for name, fx, faults in circuits]
    launches = dict(lib.launches)
    tpls = [v.tpl for v, _ in ran]
    print(f"shapes: {len(tpls)} circuits in {time.time() - t:.1f} s, launches {launches}")
    want = 2 * sum(_merkle_launches(tpl) for tpl in tpls)
    calls = 2 * len(tpls)
    field = {k: 2 * sum(_field_launches(tpl)[k] for tpl in tpls) for k in FIELD_KERNELS}
    if (launches["permutation_scan"], launches["sponge_rows"], launches["sponge_rows_grouped"], launches["merkle_fold"]) != (calls, calls, calls, want):
        raise AssertionError(f"shapes: launches {launches}, expected {calls} of the scan and of each sponge entry and {want} Merkle walks")
    if {k: launches[k] for k in field} != field:
        raise AssertionError(f"shapes: launches {launches}, expected the field kernels {field}")
    for (name, _, _), (v, batches) in zip(circuits, ran):
        hold_against_plain(v, batches, checks, f"shape {name}")
    return launches


def mesh_arrays(tpl, vkey, pwp, batch: int):
    """The mesh phase's global batch, made the same way in the parent and in
    every rank: `batch` copies of the proof, lane 1 with a flipped
    pow_witness and lane batch // 2 + 3 (another dp shard) with a flipped
    opening. Returns (arrays, the two faulted lanes)."""
    from plonky2_verifier_tpu_torch.compiler import flatten_proofs

    arrays = {k: np.repeat(a, batch, axis=0) for k, a in flatten_proofs(tpl, [(vkey, pwp)]).items()}
    bad = [1 % batch, (batch // 2 + 3) % batch]
    arrays["pow_witness"][bad[0]] ^= np.uint64(1)
    arrays["openings1"][bad[1], 0, 0] ^= np.uint64(1)
    return arrays, bad


def _rank_setup(standard, device):
    """What every rank of the mesh phase starts with: the kernel library the
    parent built (None on the CPU), a function that waits for the card (a
    no-op on the CPU), and the cached fixture."""
    import torch

    from plonky2_verifier_tpu_torch import kernels
    from plonky2_verifier_tpu_torch.compiler import CircuitTemplate
    from plonky2_verifier_tpu_torch.models.cache import get_fixture_proof

    on_card = device is None
    lib = kernels.load() if on_card else None
    common, vkey, pwp = get_fixture_proof("fibonacci", **standard)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    return lib, sync, CircuitTemplate(common), common, vkey, pwp


def mesh_verify_rank(dp: int, qp: int, batch: int, timed_calls: int, hold_rank, standard, device):
    """One rank of a dp x qp mesh of the mesh phase (every rank on the one
    card): its share of the global batch through ShardedVerifier, the launch
    counters of its first call, the gathered verdict, lane 0's transcript
    against golden in the ranks that hold it, `timed_calls` calls between
    barriers, and in rank `hold_rank` (None: in no rank) every kernel against
    its plain version at this rank's shapes."""
    import torch
    import torch.distributed as dist

    from plonky2_verifier_tpu_torch.parallel import ShardedVerifier, make_mesh
    from plonky2_verifier_tpu_torch.tools.check_hash_kernels import new_checks

    lib, sync, tpl, common, vkey, pwp = _rank_setup(standard, device)
    arrays, _ = mesh_arrays(tpl, vkey, pwp, batch)
    mesh = make_mesh(dp, qp)
    sv = ShardedVerifier(tpl, mesh, device=device)
    sharded = sv.shard_arrays(arrays)
    sync()
    launches = None
    if lib is not None:
        lib.reset_launches()
    t = time.time()
    out = sv(sharded)
    sync()
    first_s = time.time() - t
    if lib is not None:
        launches = dict(lib.launches)
        _check_launches(launches, f"rank {mesh.rank} of the {dp} x {qp} mesh", tpl)
        if launches["merkle_fold"] != _merkle_launches(tpl):
            raise AssertionError(f"rank {mesh.rank}: {launches['merkle_fold']} Merkle launches, expected {_merkle_launches(tpl)}")
    res = {"rank": mesh.rank, "at": [mesh.dp_index, mesh.qp_index], "first_s": first_s, "launches": launches,
           "ok": out["ok"].cpu().tolist(), "gathered": sv.gather(out["ok"]).tolist(), "n_valid": out["n_valid"]}
    if mesh.dp_index == 0:  # this rank holds lane 0
        sv.inner.debug = True
        with torch.no_grad():
            dbg = sv.inner(sharded, queries=sv.queries)["debug"]
        sv.inner.debug = False
        _transcript_equals_golden(common, dbg, 0, vkey, pwp)
        res["lane0_transcript_equals_golden"] = True
    dist.barrier()
    sync()
    t = time.time()
    for _ in range(timed_calls):
        sv(sharded)
    sync()
    dist.barrier()
    res["step_ms"] = (time.time() - t) / max(timed_calls, 1) * 1e3
    if mesh.rank == hold_rank:
        checks = new_checks()
        per_rank = batch // dp
        queries = None if sv.queries is None else sv.queries.stop - sv.queries.start
        hold_against_plain(sv.inner, per_rank, checks, f"rank {mesh.rank} of the {dp} x {qp} mesh", queries)
        res["held"] = {k: (c.cases, c.max_abs_err) for k, c in checks.items()}
    return res


def mesh_stream_rank(dp: int, batch: int, n_proofs: int, corrupt_every: int, standard, device):
    """One rank of the mesh phase's stream: the same `n_proofs` raw-JSON
    proofs in every rank, through StreamVerifier over a dp x 1 mesh."""
    import torch.distributed as dist

    from plonky2_verifier_tpu_torch.parallel import StreamVerifier, make_mesh
    from plonky2_verifier_tpu_torch.tools.stream_verify import proof_stream

    lib, sync, tpl, _, vkey, pwp = _rank_setup(standard, device)
    items, expected = proof_stream(vkey, pwp, n_proofs, corrupt_every, raw=True)
    mesh = make_mesh(dp, 1)
    sv = StreamVerifier(tpl, batch, mesh=mesh, raw_json=True, device=device)
    dist.barrier()
    if lib is not None:
        lib.reset_launches()
    m = sv.run(items)
    sync()
    snap = m.snapshot()
    calls_s = snap["elapsed_s"] - m.ingest_s - m.device_wait_s
    return {"rank": mesh.rank, "counts": [m.proofs, m.accepted, m.rejected, m.batches], "expected_rejected": expected,
            "launches": None if lib is None else dict(lib.launches), "snapshot": snap, "ingest_workers": sv.ingest_workers,
            "ingest_work_s": sv.ingest_work_s, "ingest_s": m.ingest_s, "device_wait_s": m.device_wait_s,
            "step_ms": calls_s / m.batches * 1e3}


def mesh_path(fixture, checks, one_process_stream: dict, step_s: float):
    """The fourth path: several processes on the one card, joined by gloo.
    2 x 1, 1 x 2 and 2 x 2 meshes through ShardedVerifier on a global batch
    of MESH_BATCH with two faulted lanes, each rank's verdicts against the
    one-process TorchVerifier's on the same arrays, then the stream over a
    2 x 1 mesh beside the one-process stream of this run. A rank that fails,
    or gives no answer in time, fails the run (parallel.run_ranks kills the
    rest). Returns the launch counts summed over the ranks of the last mesh's
    first call, and of the stream."""
    from plonky2_verifier_tpu_torch import kernels
    from plonky2_verifier_tpu_torch.parallel import run_ranks
    from plonky2_verifier_tpu_torch.verifier_torch import verify_batch

    tpl, _, vkey, pwp = fixture
    arrays, bad = mesh_arrays(tpl, vkey, pwp, MESH_BATCH)
    want = verify_batch(tpl, arrays, device=DEVICE)["ok"].tolist()
    if want != [i not in bad for i in range(MESH_BATCH)]:
        raise AssertionError(f"one process rejects lanes {[i for i, ok in enumerate(want) if not ok]}, expected {bad}")
    threads = 1 if DEVICE == "cpu" else 0
    summed = dict.fromkeys(kernels.COUNTERS, 0)
    for dp, qp in MESHES:
        world = dp * qp
        t = time.time()
        hold_rank = world - 1 if (dp, qp) in MESH_HOLDS else None
        ranks = run_ranks(mesh_verify_rank, world, (dp, qp, MESH_BATCH, MESH_TIMED_CALLS, hold_rank, STANDARD, DEVICE),
                          backend="gloo", timeout_s=MESH_TIMEOUT_S, threads=threads)
        per = MESH_BATCH // dp
        for rank, res in enumerate(ranks):
            mine = want[rank // qp * per : (rank // qp + 1) * per]
            if res["rank"] != rank or res["ok"] != mine or res["gathered"] != want or res["n_valid"] != MESH_BATCH - len(bad):
                raise AssertionError(f"mesh {dp} x {qp}, rank {rank}: lanes {res['ok'][:8]}..., gathered rejects "
                                     f"{[i for i, ok in enumerate(res['gathered']) if not ok]}, n_valid {res['n_valid']}; expected rejects {bad}")
            if rank // qp == 0 and not res.get("lane0_transcript_equals_golden"):
                raise AssertionError(f"mesh {dp} x {qp}, rank {rank} holds lane 0 and did not check its transcript")
            if DEVICE is None:  # the rank checked its own counts; here once more, from what it reported
                _check_launches(res["launches"], f"rank {rank} of the {dp} x {qp} mesh", tpl)
        if hold_rank is not None and "held" not in ranks[hold_rank]:
            raise AssertionError(f"mesh {dp} x {qp}: rank {hold_rank} did not hold the kernels against their plain versions")
        for k, (cases, err) in ranks[-1].get("held", {}).items():
            checks[k].cases += cases
            checks[k].max_abs_err = max(checks[k].max_abs_err, err)
        steps = [r["step_ms"] for r in ranks]
        print(f"mesh {dp} x {qp}: {world} processes on one card, global batch {MESH_BATCH} ({per} lanes, {tpl.num_queries // qp} queries a rank): "
              f"every rank's lanes and the gathered verdict equal one process's, n_valid {ranks[0]['n_valid']} on every rank, rejected lanes {bad}; "
              f"lane 0's transcript equals golden in ranks {[r['rank'] for r in ranks if r.get('lane0_transcript_equals_golden')]}; "
              f"first call {[round(r['first_s'], 3) for r in ranks]} s, launches a rank {ranks[0]['launches']}; "
              f"step_ms a rank {[round(x, 3) for x in steps]} -> {MESH_BATCH / max(steps) * 1e3:.1f} proofs/s over the mesh "
              f"(one process, batch {BATCH}: {step_s * 1e3:.3f} ms, {BATCH / step_s:.1f} proofs/s)"
              + (f"; rank {hold_rank} held the kernels against plain at its shapes" if hold_rank is not None else "") + f"; {time.time() - t:.1f} s")
        if DEVICE is None:
            summed = {k: sum(r["launches"][k] for r in ranks) for k in kernels.COUNTERS}

    dp = MESH_STREAM_DP
    t = time.time()
    ranks = run_ranks(mesh_stream_rank, dp, (dp, MESH_STREAM_BATCH, MESH_STREAM_PROOFS, STREAM_CORRUPT_EVERY, STANDARD, DEVICE),
                      backend="gloo", timeout_s=MESH_TIMEOUT_S, threads=threads)
    expected = MESH_STREAM_PROOFS // STREAM_CORRUPT_EVERY
    batches = -(-MESH_STREAM_PROOFS // MESH_STREAM_BATCH)
    want_launches = {"permutation": 0, "permutation_scan": batches, "sponge_rows": batches,
                     "sponge_rows_grouped": batches, "merkle_fold": batches * _merkle_launches(tpl),
                     **{k: batches * n for k, n in _field_launches(tpl).items()}}
    for rank, res in enumerate(ranks):
        if res["counts"] != [MESH_STREAM_PROOFS, MESH_STREAM_PROOFS - expected, expected, batches]:
            raise AssertionError(f"mesh stream, rank {rank}: (proofs, accepted, rejected, batches) = {res['counts']}")
        if DEVICE is None and res["launches"] != want_launches:
            raise AssertionError(f"mesh stream, rank {rank}: launches {res['launches']}, expected {want_launches}")
    rate = min(r["snapshot"]["proofs_per_sec"] for r in ranks)
    print(f"mesh stream {dp} x 1: {MESH_STREAM_PROOFS} proofs at global batch {MESH_STREAM_BATCH}, counts {ranks[0]['counts']} on every rank, "
          f"launches a rank {ranks[0]['launches']}, {ranks[0]['ingest_workers']} ingest workers a rank; {rate} proofs/s over all "
          f"(the slower rank's clock; after the first batch {[r['snapshot']['steady_proofs_per_sec'] for r in ranks]}) beside the one-process "
          f"stream's {one_process_stream['proofs_per_sec']} ({one_process_stream['steady_proofs_per_sec']} after the first batch) in this run: "
          f"ratio {rate / one_process_stream['proofs_per_sec']:.3f}; step a rank (elapsed - ingest_s - device_wait_s, a batch) "
          f"{[round(r['step_ms'], 3) for r in ranks]} ms for {MESH_STREAM_BATCH // dp} lanes; ingest work s {[round(r['ingest_work_s'], 3) for r in ranks]}, "
          f"paid {[round(r['ingest_s'], 3) for r in ranks]}, device_wait_s {[round(r['device_wait_s'], 3) for r in ranks]}; {time.time() - t:.1f} s")
    stream_launches = {k: sum(r["launches"][k] for r in ranks) for k in kernels.COUNTERS} if DEVICE is None else dict(summed)
    return summed, stream_launches


def profile_path():
    """tools/profile_verifier.py at each (model, batch) of PROFILE: stage
    times, launches a forward and the card's idle share, one line each."""
    from plonky2_verifier_tpu_torch.tools.profile_verifier import profile_verifier

    for model, batch in PROFILE:
        t = time.time()
        res = profile_verifier(model, batch, DEVICE)
        staged = sum(res["stages_ms"].values())
        if not 0.95 * res["staged_call_ms"] <= staged <= res["staged_call_ms"]:
            raise AssertionError(f"profile {model}: the stages add up to {staged} ms of a call of {res['staged_call_ms']} ms")
        print(f"profile {model} batch {batch} ({time.time() - t:.1f} s): {json.dumps(res)}")


def main():
    t_start = time.time()
    smi, rate = device_phase()
    sys.path.insert(0, ROOT)
    import torch

    from plonky2_verifier_tpu_torch import kernels
    from plonky2_verifier_tpu_torch.ops.poseidon import PoseidonConstants
    from plonky2_verifier_tpu_torch.tools.check_hash_kernels import check_kernels

    last = [time.time()]

    def phase(name: str):
        print(f"phase_s {name} {time.time() - last[0]:.1f}", flush=True)
        last[0] = time.time()

    provers = [start_prover("fibonacci", STANDARD), start_prover("gate_zoo", ZOO)]  # both prove beside the build and the kernel checks
    try:
        t = time.time()
        lib = kernels.load()
        print(f"build_s {time.time() - t:.1f}")
        consts = PoseidonConstants()

        checks = check_kernels(lib, consts)  # phase 3, at that tool's full size
        phase("build and kernel checks")
        shape_launches = shapes_path(lib, checks)  # phase 11 here: it needs no cached fixture, and the children are still proving
        phase("shape circuits")
        wait_for_prover(provers[0], "fibonacci")
        v, dev, launches, fib = main_path(lib, checks)
        phase("main path")
        zoo = zoo_fixture(provers[1])
    finally:
        for prover in provers:
            if prover.poll() is None:
                prover.kill()
                prover.wait()
    times = time_kernels(lib, consts, v, dev, checks, rate, zoo[0])
    step_s = time_main_path(v, dev, BATCH, TIMED_CALLS)
    del v, dev
    bench_once(smi, launches)
    phase("kernel times and timed calls")
    zoo_launches = zoo_path(lib, zoo, checks)
    phase("gate-zoo path")
    ingest = ingest_phase(fib)
    stream_launches, stream_snap = stream_path(lib, fib, step_s, ingest)
    phase("ingest and stream")
    cli_launches = cli_path(lib, {"fibonacci": fib, "gate_zoo": zoo}, checks)
    phase("command line")
    mesh_launches, mesh_stream_launches = mesh_path(fib, checks, stream_snap, step_s)
    phase("mesh of processes")
    profile_path()
    phase("profiles")
    if "--sass" in sys.argv[1:]:
        print_sass()
    paths = [("the main path", launches)] + [(f"the gate-zoo path at batch {b}", n) for b, n in zoo_launches.items()]
    paths += [(f"the stream of {STREAM_PROOFS}", stream_launches), ("the command line's stream", cli_launches), ("the shape circuits", shape_launches)]
    paths += [(f"the {MESHES[-1][0]} x {MESHES[-1][1]} mesh's first call, its ranks together", mesh_launches),
              (f"the mesh stream of {MESH_STREAM_PROOFS}, its ranks together", mesh_stream_launches)]
    for what, n in paths:
        print(f"launches on {what}: " + ", ".join(f"{k} {n[k]}" for k in kernels.COUNTERS))
    print(f"card: {smi}")

    sources = {"permutation": "permutation.cu", "sponge_rows": "sponge.cu", "merkle_fold": "merkle.cu", "horner": "field.cu", "inv": "field.cu",
               "pow": "field.cu", "gate_program": "gates.cu", "coset_fold": "fold.cu", "partial_products": "plonk.cu", "lookup_checks": "plonk.cu",
               "gate_filter": "plonk.cu"}
    replaces = {
        "permutation": "plonky2_verifier_tpu/ops/pallas_poseidon.py:122",
        "sponge_rows": "plonky2_verifier_tpu/ops/pallas_hash.py:112",
        "merkle_fold": "plonky2_verifier_tpu/ops/pallas_hash.py:171",
        # no Pallas kernel: functions that jax.jit compiles into loops on the device
        "horner": "plonky2_verifier_tpu/verifier_jax.py:45 horner_ext (and :62 horner_scaled)",
        "inv": "plonky2_verifier_tpu/ops/field.py:264 inv",
        "pow": "plonky2_verifier_tpu/ops/field.py:413 pow_dynamic (and :399 ext_pow_const)",
        "gate_program": "plonky2_verifier_tpu/compiler/gates_jax.py:225 run_levelized",
        "coset_fold": "plonky2_verifier_tpu/verifier_jax.py:749-810 (_fri_checks' coset fold)",
        "partial_products": "plonky2_verifier_tpu/verifier_jax.py:345-385 (_plonk_checks' L0 and partial products)",
        "lookup_checks": "plonky2_verifier_tpu/verifier_jax.py:468-642 _lookup_checks",
        "gate_filter": "plonky2_verifier_tpu/verifier_jax.py:393-418 (_plonk_checks' selectors and filtered sum)",
    }
    entry_points = {
        "permutation": ("permutation", "permutation_scan"),
        "sponge_rows": ("sponge_rows", "sponge_rows_grouped"),
        "merkle_fold": ("merkle_fold",),
        "horner": ("horner",),
        "inv": ("inv", "inv_grouped"),
        "pow": ("pow", "pow_grouped"),
        "gate_program": ("gate_program",),
        "coset_fold": ("coset_fold",),
        "partial_products": ("partial_products",),
        "lookup_checks": ("lookup_checks",),
        "gate_filter": ("gate_filter",),
    }
    rows = []
    for name in kernels.KERNELS:
        tm = times[name]
        row = {
            "name": name,
            "route": "cuda",
            "source": f"plonky2_verifier_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            # a kernel's entry points count together; the first path's run
            "launches": sum(launches[k] for k in entry_points[name]),
            "max_abs_err": checks[name].max_abs_err,
            "ms": round(tm["ms"], 6),
            "device_ms": round(tm["device_ms"], 6),
            "plain_ms": round(tm["plain_ms"], 6),
            "bound_ms": round(tm["bound_ms"], 6),
            "bound_by": tm["bound_by"],
            "library_ms": None,  # no PyTorch operator computes Poseidon or any arithmetic over Goldilocks
        }
        for b, n in zoo_launches.items():
            row[f"launches_zoo_{b}"] = sum(n[k] for k in entry_points[name])
        if not row["launches"]:  # a kernel the main path's template never reaches (the lookup argument): its own path's run
            b = max(zoo_launches)
            row["launches"], row["launches_path"] = row[f"launches_zoo_{b}"], f"the gate-zoo path at batch {b}"
        row["launches_stream"] = sum(stream_launches[k] for k in entry_points[name])
        row["launches_cli"] = sum(cli_launches[k] for k in entry_points[name])
        row["launches_shapes"] = sum(shape_launches[k] for k in entry_points[name])
        # every rank of the last mesh's first call, and of the mesh stream, together
        row["launches_mesh"] = sum(mesh_launches[k] + mesh_stream_launches[k] for k in entry_points[name])
        # beside the launch the main path makes: one (1024, 12) permutation
        # step beside the scan, the widest single matrix beside the grouped
        # sponge, the gate zoo's largest call beside the main path's, the
        # grouped inversion's and exponentiation's work one launch a call
        for extra in ("step", "widest", "zoo", "apart"):
            if extra in tm:
                row.update({f"{extra}_{k}": round(x, 6) if isinstance(x, float) else x for k, x in tm[extra].items()})
        if "wrapper_ms" in tm:  # the grouped inversion's call through ops/field: concatenation, launch, split
            row["wrapper_ms"] = round(tm["wrapper_ms"], 6)
        if "timed_on" in tm:  # the path whose largest call the times are of
            row["timed_on"] = tm["timed_on"]
        rows.append(row)
    print(f"total_s {time.time() - t_start:.1f}")
    print(json.dumps({"kernels": rows}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
