// p2v_coset_fold: every FRI fold step's coset fold of one verifier forward
// in one launch.
//
// No Pallas kernel: the JAX package's fold (plonky2_verifier_tpu/
// verifier_jax.py:749-810, its IDFT a lax.scan over the arity) is compiled
// by jax.jit into a few loops on the device. Run eagerly as plain PyTorch
// (verifier_torch.coset_fold_plain) a step was a loop of A extension
// scalings and adds for the IDFT, the powers of the offset's inverse by
// doubling, a scaling, the beta-Horner and a last scaling: ~2,300 launches a
// step at arity 16, about half of a fibonacci forward's launches.
//
// What it computes, a (b, q) of each step (golden/fri.py fold_coset): the
// A opened coset values v (bit-reversed order) to subgroup order, the
// A-point inverse DFT y'_k = sum_j omega^(-jk) v_(rev j), y_k = off_inv^k y'_k,
// and (1/A) sum_k beta^k y_k. A step's fold depends only on its own opened
// values, its offset's inverse and its beta, never on the step before (that
// one is only compared with the opened slot), so every step of a forward
// goes into one launch: a table of steps passed by value
// (__grid_constant__, as p2v_pow_grouped passes its segments), a thread a
// (step, b, q).
//
// Order: with c = beta off_inv (one extension word a thread) the sum is
// sum_k c^k y'_k, a Horner chain in c from k = A - 1 down, each y'_k formed
// as it is needed from the A values and row k of the IDFT weights (the
// verifier's (A, A) table, read by every thread alike). Bits: the plain
// version's every value is a canonical product or a sum of canonical words
// (the opened values, which may be words x + p, only enter products), and a
// canonical value is unique, so this order gives its words. The step's
// values are read A times each (from L1 after the first).
//
// Bound (chip_smoke.fold_work): integer ALU work, counted for the least
// work the function needs, an FFT of A log2(A) / 2 butterflies (a base-field
// twiddle times an extension value, 2 products, and 4 adds) and the Horner
// chain (4 products and 4 adds a value) a (b, q); against the bytes, the
// values read once and the folded pair written once. This kernel spends A^2
// scalings (2 products and 2 adds each) on the IDFT instead of the FFT's
// butterflies: 256 against 32 at A = 16. Shared-memory staging or a
// butterfly IDFT is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

using gl::Ext;

namespace {

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_MAX_STEPS = 32;  // fold steps a launch (kernels.FOLD_MAX_STEPS): lde_bits <= 32, a step takes >= 1 bit

// One fold step; kernels.FoldStep field for field.
struct FoldStep {
    const uint64_t* evals;    // (B, Q, A, 2): value j of (b, q) at b * e_row + q * e_query + 2 j (+ 1 for im)
    const uint64_t* off_inv;  // (B, Q): at b * o_row + q * o_query
    const uint64_t* beta_re;  // (B,): at b * beta_stride
    const uint64_t* beta_im;
    const uint64_t* idft;     // (A, A): omega^(-jk) at k A + j, canonical
    uint64_t* out;            // (2, B, Q) contiguous: real parts, then imaginary parts
    int64_t e_row, e_query, o_row, o_query, beta_stride;
    uint64_t inv_arity;       // 1 / A, canonical
    int32_t arity_bits;
    int32_t unused;
};

struct FoldGroup {
    FoldStep step[FOLD_MAX_STEPS];
    int64_t queries;  // Q
    int64_t per_step;  // B Q
    int64_t total;     // steps B Q < 2^31
};

__global__ void __launch_bounds__(FOLD_THREADS) coset_fold_kernel(const __grid_constant__ FoldGroup g) {
    const int64_t t = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
    if (t >= g.total) return;
    const int s = (int)(t / g.per_step);
    const int64_t i = t - s * g.per_step;
    const int64_t b = i / g.queries, q = i - b * g.queries;
    const FoldStep& a = g.step[s];  // read where it lies in the grid-constant table
    const int bits = a.arity_bits, arity = 1 << bits;
    const uint64_t* v = a.evals + b * a.e_row + q * a.e_query;
    const uint64_t oi = a.off_inv[b * a.o_row + q * a.o_query];
    const Ext beta = {a.beta_re[b * a.beta_stride], a.beta_im[b * a.beta_stride]};
    const gl::Point c = gl::point(gl::escale(oi, beta));
    Ext acc = {0, 0};
    for (int k = arity - 1; k >= 0; --k) {
        const uint64_t* w = a.idft + (int64_t)k * arity;
        Ext y = {0, 0};
        for (int j = 0; j < arity; ++j) {
            const int at = bits ? (int)(__brev((unsigned)j) >> (32 - bits)) : 0;  // subgroup order
            y = gl::eadd(y, gl::escale(w[j], {v[2 * at], v[2 * at + 1]}));
        }
        acc = gl::eadd(y, gl::emul(c, acc));
    }
    a.out[i] = gl::mul(a.inv_arity, acc.re);
    a.out[g.per_step + i] = gl::mul(a.inv_arity, acc.im);
}

}  // namespace

// `count` steps (a host array of FoldStep), each over the same (batch,
// queries) lanes, in one launch.
extern "C" int p2v_coset_fold(const void* steps, int count, int64_t batch, int64_t queries, void* stream) {
    if (count < 0 || count > FOLD_MAX_STEPS || batch < 0 || queries < 0) return (int)cudaErrorInvalidValue;
    FoldGroup g = {};
    const FoldStep* step = (const FoldStep*)steps;
    for (int k = 0; k < count; ++k) {
        if (step[k].arity_bits < 0 || step[k].arity_bits > 30) return (int)cudaErrorInvalidValue;
        g.step[k] = step[k];
    }
    g.queries = queries > 0 ? queries : 1;
    g.per_step = batch * queries;
    g.total = g.per_step * count;
    if (g.total >= INT32_MAX) return (int)cudaErrorInvalidValue;
    if (g.total > 0) {
        const unsigned blocks = (unsigned)((g.total + FOLD_THREADS - 1) / FOLD_THREADS);
        coset_fold_kernel<<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>(g);
    }
    return (int)cudaGetLastError();
}
