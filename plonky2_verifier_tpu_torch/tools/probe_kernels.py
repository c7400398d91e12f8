"""A one-minute probe of the Poseidon kernels on the card, for development:
what chip_smoke.py measures about the kernels, without the fixture and the
verifier.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.probe_kernels [--field | --stages | --lookup-lanes | --pp-lanes]

With --field it builds, runs the whole check (step 2) and then only the
field probe: the Horner sum at the main path's shapes (batch 1024, 28
queries) and the gate program of the fibonacci and gate-zoo circuits at
1024 lanes, each as the library launches it (segments a row; lanes and
threads a block), beside its bound.

With --stages it builds and runs chip_smoke.py's kernel times (its phase 5,
`time_kernels`) alone, on the standard fixture's proof at batch 1024 and
the gate zoo's template (both cached under fixtures/, or proved first), and
prints the rows of the three stage kernels -- the coset folds, L0 with the
partial products, the lookup argument -- as one JSON line: kernel ms by
events, device ms, plain ms, bound and share. No check runs first; each
timed call is held bit-exact against its plain version there.

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

With --pp-lanes it builds the kernels with kernels.PP_VARIANTS_FLAG and
times the partial-product kernel on the main path's call (the standard
shape's template, batch 1024, random proof words) in both forms -- a group
a (b, round, chunk), and a group a (b, chunk) whose lanes run the rounds
one after the other -- at 1 to 32 lanes a chunk and under launch bounds of
1, 3 and 4 blocks an SM, beside the shipped launch
(kernels.partial_products_lanes, the first form), with the device ms and
the kernel's own count; each call held bit-exact against the plain
version. Last the shipped launch on one b: a block's time, the floor that
a launch of the kernel costs under the device timing.

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
   launch each, and the kernel under other launch bounds, with other
   numbers of blocks an SM, and with blocks that stride where the shipped
   ones draw their rows from a counter (csrc/sponge.cu built with
   -DP2V_SPONGE_VARIANTS), every variant held bit-exact against the shipped
   kernel;
5. builds csrc/probe_cycles.cu and prints the cycles one warp spends in one
   modular multiply, one S-box, one shuffle, and one permutation in each
   form (clock64 around 20 dependent repetitions);
6. prints the SASS instruction count of one permutation (chip_smoke.print_sass).

Any failed check raises. Times are CUDA-event times of repeated launches.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

from .. import kernels
from ..ops import field as tf
from ..ops import poseidon as tp
from .bench_poseidon import _host_ms, device_ms, event_ms
from .check_hash_kernels import check_kernels, rand_words

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
# csrc/sponge.cu p2v_sponge_rows_variant: (launch bound, blocks an SM, drawn)
SPONGE_VARIANTS = [(16, g, True) for g in (4, 6, 8, 10, 12, 16)] + [
    (16, 8, False),
    (16, 0, False),
    (28, 8, True),
    (28, 28, True),
    (1, 8, True),
]


def probe_sponge_groups(lib, rng, rate):
    """The grouped launch beside one launch a matrix, then the kernel under
    each of SPONGE_VARIANTS, on the matrices of SPONGE_GROUPS."""
    variants = kernels.KernelLibrary(kernels.build((kernels.SPONGE_VARIANTS_FLAG,)))
    for name, shapes in SPONGE_GROUPS.items():
        group = [tf.from_u64(rand_words(rng, shape), "cuda") for shape in shapes]
        perms = sum(n * -(-w // 8) for n, w in shapes)
        bound = cs.bound_ms(perms, sum(n * (w + 4) * 8 for n, w in shapes), rate)[0]
        want = lib.sponge_rows_grouped(group)
        for g, rows in zip(want, group):
            if not torch.equal(g, lib.sponge_rows(rows, rows.shape[1])):
                raise AssertionError(f"{name}: grouped launch differs from sponge_rows at {tuple(rows.shape)}")
        apart = event_ms(lambda: [lib.sponge_rows(rows, rows.shape[1]) for rows in group], 20, 3)
        ms = event_ms(lambda: lib.sponge_rows_grouped(group), 20, 3)
        print(f"sponge group {name} ({perms} permutations): one launch {ms:.4f} ms, six launches {apart:.4f} ms, "
              f"bound {bound:.4f} ms, share {bound / ms:.3f}")
        for variant in SPONGE_VARIANTS:
            for g, w in zip(variants.sponge_rows_grouped(group, variant), want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: variant {variant} differs from the shipped kernel")
            ms = event_ms(lambda: variants.sponge_rows_grouped(group, variant), 20, 3)
            one = event_ms(lambda: variants.sponge_rows_grouped(group[:1], variant), 20, 3)
            blocks = f"{variant[1]} blocks an SM" if variant[1] else "one block a warp of rows"
            print(f"sponge group {name}, launch bound {variant[0]}, {blocks}, {'drawn' if variant[2] else 'strided'}: "
                  f"{ms:.4f} ms, share {bound / ms:.3f}; {tuple(group[0].shape)} alone {one:.4f} ms")


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
        bound = cs.field_bound_ms(*cs.horner_work(args), rate)[0]
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
        bound = cs.field_bound_ms(*cs.gate_work(packed, inputs), rate)[0]
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


def probe_stages(lib, rate, smi: str):
    """chip_smoke.time_kernels at the main path's shapes; prints its stage
    kernels' rows as one JSON line, then the SASS instructions each of
    goldilocks.cuh's ops executes (field_sass_counts) and the three stage
    kernels' own counts at those weights beside their device time."""
    import json

    from .. import verifier_torch as vt
    from ..compiler import CircuitTemplate, flatten_proofs
    from ..models.cache import get_fixture_proof
    from ..verifier_torch import TorchVerifier
    from .check_hash_kernels import new_checks

    common, vkey, pwp = get_fixture_proof("fibonacci", **cs.STANDARD)
    tpl = CircuitTemplate(common)
    v = TorchVerifier(tpl)
    dev = v.prepare(flatten_proofs(tpl, [(vkey, pwp)] * cs.BATCH))
    zoo_tpl = CircuitTemplate(get_fixture_proof("gate_zoo", **cs.ZOO)[0])
    times = cs.time_kernels(lib, tp.PoseidonConstants(), v, dev, new_checks(), rate, zoo_tpl)
    print(json.dumps({"card": smi, **{k: times[k] for k in ("coset_fold", "partial_products", "lookup_checks")}}))

    sass = field_sass_counts()
    for name, ops in sass.items():
        print(f"sass {name}: {sum(ops.values()):g} instructions: " + ", ".join(f"{op} {n:g}" for op, n in sorted(ops.items(), key=lambda kv: -kv[1])))
    total = {name: sum(ops.values()) for name, ops in sass.items()}
    product, add = total["mul"], total["add"]
    weights = {"mul": product, "mul_add": total["mul_add"], "mul_add2": total["mul_add2"], "emul": total["emul_once"], "sub": total["sub"]}
    zoo_v = TorchVerifier(zoo_tpl)
    zoo_dev = zoo_v.prepare(cs.random_arrays(zoo_tpl, cs.BATCH, zoo_tpl.num_queries, np.random.default_rng(5)))
    ((_, fold_args, _),) = cs.recorded_calls([(vt, "coset_folds")], v, dev)
    ((_, lookup_args, _),) = cs.recorded_calls([(vt, "lookup_checks")], zoo_v, zoo_dev)
    ((_, pp_args, _),) = cs.recorded_calls([(vt, "partial_products")], v, dev)
    issue = rate / cs.INT32_LANES_PER_SM * 128  # 4 schedulers an SM, each a warp instruction a clock
    counts = {"coset_fold": (cs.fold_work(*fold_args)[3], cs.fold_work(*fold_args, product=product, add=add)[3], f"{product:g} a product and {add:g} an add"),
              "lookup_checks": (cs.lookup_work(*lookup_args)[3], cs.lookup_work(*lookup_args, product=product, add=add)[3],
                                f"{product:g} a product and {add:g} an add"),
              "partial_products": (cs.partial_products_work(*pp_args)[3], cs.partial_products_work(*pp_args, weights=weights)[3],
                                   ", ".join(f"{k} {n:g}" for k, n in weights.items()))}
    for name, (at_w, at_sass, weighed) in counts.items():
        ms = times[name]["device_ms"]
        print(f"sass {name}: its own count {at_w} instructions at {cs.PRODUCT} a product and {cs.ADD} an add, {at_sass} at {weighed} "
              f"(the SASS counts above); over its device {ms:.4f} ms: {at_w / ms * 1e3:.4g} /s = {at_w / ms * 1e3 / rate:.3f} of the int32 rate, "
              f"{at_sass / ms * 1e3:.4g} SASS /s = {at_sass / ms * 1e3 / rate:.3f} of the int32 rate ({rate:.4g} /s), "
              f"{at_sass / ms * 1e3 / issue:.3f} of the issue rate ({issue:.4g} /s)")


def probe_pp_lanes(lib, rng):
    """The partial-product kernel's device ms on the main path's call in
    both forms, at every lanes a chunk and under three launch bounds
    (p2v_partial_products_variant), then the shipped launch on one b."""
    from .. import verifier_torch as vt
    from ..compiler import CircuitTemplate
    from ..models.cache import get_fixture_proof

    variants = kernels.KernelLibrary(kernels.build((kernels.PP_VARIANTS_FLAG,)))
    tpl = CircuitTemplate(get_fixture_proof("fibonacci", **cs.STANDARD)[0])
    v = vt.TorchVerifier(tpl)
    ((_, args, _),) = cs.recorded_calls([(vt, "partial_products")], v, v.prepare(cs.random_arrays(tpl, cs.BATCH, tpl.num_queries, rng)))
    want = cs.words_of(vt.partial_products_plain(*args))
    pairs = [(x.re, x.im) if isinstance(x, tf.GExt) else x.contiguous() if isinstance(x, torch.Tensor) else x for x in args]
    maxdeg = args[-1]
    shipped = kernels.partial_products_lanes(maxdeg)
    runs = [("the shipped launch", shipped, lambda: lib.partial_products(*pairs))] + [
        (f"{lanes} lanes a {'(b, chunk), the rounds in turn' if all_rounds else '(b, round, chunk)'}, launch bound {blocks} blocks an SM",
         lanes, lambda lanes=lanes, all_rounds=all_rounds, blocks=blocks: variants.partial_products(*pairs, variant=(lanes, all_rounds, blocks)))
        for blocks in (1, 3, 4) for all_rounds in (False, True) for lanes in (1, 2, 4, 8, 16, 32)]
    for what, lanes, run in runs:
        if not torch.equal(cs.words_of(tf.GExt(*run())), want):
            raise AssertionError(f"partial_products, {what}, differs from the plain version")
        print(f"pp lanes: {what}: device {device_ms(run, 20, 3):.4f} ms; the kernel's own count {cs.partial_products_work(*args, lanes=lanes)[3]}")
    one = [(x[0][:1], x[1][:1]) if isinstance(x, tuple) else x[:1] if i < 10 else x for i, x in enumerate(pairs)]
    print(f"pp lanes: the shipped launch on one b (a block, the launch's floor): device {device_ms(lambda: lib.partial_products(*one), 20, 3):.4f} ms")


def probe_lookup_lanes(rng):
    """The lookup kernel's device ms on the zoo's call under other lanes."""
    from .. import verifier_torch as vt
    from ..compiler import CircuitTemplate
    from ..models.cache import get_fixture_proof

    tpl = CircuitTemplate(get_fixture_proof("gate_zoo", **cs.ZOO)[0])
    v = vt.TorchVerifier(tpl)
    ((_, args, kwargs),) = cs.recorded_calls([(vt, "lookup_checks")], v, v.prepare(cs.random_arrays(tpl, cs.BATCH, tpl.num_queries, rng)))
    want = cs.words_of(vt.lookup_checks_plain(*args))
    routed, maxdeg, n_sldc, bounds = args[7], args[8], tpl.common.num_lookup_polys - 1, args[6].tolist()
    for slots in (1, 2, 4, 8):
        for values in (1, 2, 4, 8):
            lanes = kernels.lookup_split(routed, n_sldc, maxdeg, bounds, slots, values)
            run = lambda: vt.lookup_checks(*args, lanes=lanes)
            if not torch.equal(cs.words_of(run()), want):
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
    smi, rate = cs.device_phase()
    t = time.time()
    lib = kernels.load()
    print(f"build_s {time.time() - t:.1f}")
    if "--stages" in sys.argv[1:]:
        probe_stages(lib, rate, smi)
        return
    if "--lookup-lanes" in sys.argv[1:]:
        probe_lookup_lanes(np.random.default_rng(5))
        print(f"card: {smi}")
        return
    if "--pp-lanes" in sys.argv[1:]:
        probe_pp_lanes(lib, np.random.default_rng(5))
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
        print(f"permutation n={n}: thread {ms['thread']:.4f} ms, split {ms['split']:.4f} ms, bound {cs.bound_ms(n, n * 192, rate)[0]:.5f} ms")

    mask = np.zeros((N_PERMS, 12), dtype=bool)
    mask[:, :8] = True
    idx = (np.arange(N_PERMS * 12).reshape(N_PERMS, 12) % N_DATA).astype(np.int64)
    ov_idx, ov_mask = torch.from_numpy(idx).cuda(), torch.from_numpy(mask).cuda()
    for batch in SCAN_BATCHES:
        data = tf.from_u64(rand_words(rng, (batch, N_DATA)), "cuda")
        ms = {f: event_ms(lambda: lib.permutation_scan(data, ov_idx, ov_mask, f), 5, 2) for f in ("thread", "split")}
        print(f"scan B={batch}: thread {ms['thread']:.4f} ms, split {ms['split']:.4f} ms, bound {cs.bound_ms(batch * N_PERMS, 0, rate)[0]:.5f} ms")

    for n, path_len in MERKLE_SHAPES:
        dig = tf.from_u64(rand_words(rng, (n, 4)), "cuda")
        index = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.int64)).cuda()
        sib = tf.from_u64(rand_words(rng, (n, path_len, 4)), "cuda")
        ms, bound = event_ms(lambda: lib.merkle_fold(dig, index, sib), 20, 3), cs.bound_ms(n * path_len, 0, rate)[0]
        print(f"merkle_fold ({n}, L={path_len}): {ms:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f}")
    for n, width in SPONGE_SHAPES:
        rows = tf.from_u64(rand_words(rng, (n, width)), "cuda")
        ms, bound = event_ms(lambda: lib.sponge_rows(rows, width), 20, 3), cs.bound_ms(n * -(-width // 8), 0, rate)[0]
        print(f"sponge_rows ({n}, {width}): {ms:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f}")
    probe_sponge_groups(lib, rng, rate)
    probe_field(lib, rng, rate)

    print(cycles_probe())
    cs.print_sass()
    print(f"card: {smi}")


if __name__ == "__main__":
    sys.exit(main())
