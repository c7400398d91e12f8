"""A one-minute probe of the Poseidon kernels on the card, for development:
what chip_smoke.py measures about the kernels, without the fixture and the
verifier.

Run from the repository root:  python3 -m plonky2_verifier_tpu_torch.tools.probe_kernels

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
6. prints the SASS instruction count of one permutation (kernels.sass_instruction_count).

Any failed check raises. Times are CUDA-event times of repeated launches.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

from .. import kernels
from ..ops import field as tf
from ..ops import poseidon as tp
from .bench_poseidon import event_ms
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
    consts = tp.PoseidonConstants()
    check_kernels(lib, consts, n_random=5000)

    rng = np.random.default_rng(3)
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

    print(cycles_probe())
    counts = kernels.sass_instruction_count()
    print(f"sass: {sum(counts.values())} instructions in one thread-form permutation (W = {cs.W_INSTRUCTIONS}): "
          + ", ".join(f"{k} {n}" for k, n in sorted(counts.items(), key=lambda kv: -kv[1])))
    print(f"card: {smi}")


if __name__ == "__main__":
    sys.exit(main())
