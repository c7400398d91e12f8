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
// (__grid_constant__, as p2v_pow_grouped passes its segments). A block takes
// FOLD_ITEMS consecutive (b, q)s of one step, a thread each; step s owns
// blocks s * blocks_a_step ... (s + 1) * blocks_a_step - 1.
//
// Order, a thread's (b, q):
// 1. Stage: the A opened values, each word made canonical once
//    (x >= p ? x - p : x). In the shared form (arity up to 2^FOLD_SHARED_MAX_BITS)
//    the block copies its items' (A, 2) rows into shared memory, consecutive
//    threads on consecutive words of the rows (coalesced; the rows of
//    neighbouring queries are neighbours in the proof arrays); word w of
//    item t lies at w (FOLD_ITEMS + 1) + t, so a warp's threads, one item
//    each, touch 32 banks in a row, and the copy's 32 words of one item do
//    too. Above it (the global form: arities no FRI config in use picks)
//    a thread copies its own values to device scratch that the wrapper
//    allocates (torch.empty), word w of item i at w B Q + i, so that the
//    butterflies' accesses are coalesced there too.
// 2. The inverse DFT in place as a radix-2 decimation-in-time butterfly
//    network: values in bit-reversed order in (as the proof holds them),
//    y' in natural order out, no gather. A log2(A) / 2 butterflies; the
//    twiddle of butterfly j at span 2h is omega^(-j A / (2h)), from row 1
//    of the verifier's (A, A) table (omega^(-m) at m; in shared memory in the
//    shared form), and the product is skipped where j = 0 (the twiddle is
//    1): 17 twiddle products of the 32 butterflies at A = 16.
// 3. With c = beta off_inv (a gl::Point), the Horner chain in c from
//    k = A - 1 down over y'_k, then the scaling by 1/A.
// Bits: the plain version only multiplies the raw opened values (escale),
// and a product is canonical for any word; a butterfly adds them, and `add`
// of two words >= p is not exact (goldilocks.cuh). So the values are made
// canonical first; then every operand of every add and subtraction is
// canonical, every value is the canonical representative of the same sum
// mod p, and a canonical value is unique: the plain version's words.
//
// Bound (tools/probe_kernels.fold_work): integer ALU work, counted for the least
// work the function needs, an FFT of A log2(A) / 2 butterflies (4 adds
// each, and a base-field twiddle times an extension value, 2 products, in
// all but the A - 1 whose twiddle is 1) and the Horner chain (4 products
// and 4 adds a value) a (b, q); against the bytes, the values read once and
// the folded pair written once. This kernel's own count is higher by the
// canonicalisation (2A compares a (b, q)).
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

using gl::Ext;

namespace {

constexpr int FOLD_ITEMS = 64;  // (b, q)s a block, a thread each: a forward's 57,344 make 896 blocks, ~7 an SM
constexpr int FOLD_MAX_STEPS = 32;  // fold steps a launch (kernels.FOLD_MAX_STEPS): lde_bits <= 32, a step takes >= 1 bit
constexpr int FOLD_SHARED_MAX_BITS = 5;  // the shared form's largest arity, 2^5 (kernels.FOLD_SHARED_MAX_BITS): 33 KB a block
// The largest arity bits a launch takes (kernels.FOLD_MAX_ARITY_BITS). Plonky2's MinSize strategy picks at
// most 2^4 by default; any FRI step's arity divides the LDE (at most 2^32 points, Goldilocks' two-adicity),
// and the step's (A, A) table of weights alone exceeds the card's memory from A = 2^17 on.
constexpr int FOLD_MAX_ARITY_BITS = 30;

// One fold step; kernels.FoldStep field for field.
struct FoldStep {
    const uint64_t* evals;    // (B, Q, A, 2): value j of (b, q) at b * e_row + q * e_query + 2 j (+ 1 for im)
    const uint64_t* off_inv;  // (B, Q): at b * o_row + q * o_query
    const uint64_t* beta_re;  // (B,): at b * beta_stride
    const uint64_t* beta_im;
    const uint64_t* idft;     // (A, A): omega^(-jk) at k A + j, canonical
    uint64_t* out;            // (2, B, Q) contiguous: real parts, then imaginary parts
    uint64_t* scratch;        // the global form's (2A, B Q) words, else null
    int64_t e_row, e_query, o_row, o_query, beta_stride;
    uint64_t inv_arity;       // 1 / A, canonical
    int32_t arity_bits;
    int32_t unused;
};

struct FoldGroup {
    FoldStep step[FOLD_MAX_STEPS];
    int64_t queries;       // Q
    int64_t per_step;      // B Q < 2^31
    int64_t blocks_a_step;
};

__device__ __forceinline__ uint64_t canonical(uint64_t x) { return x >= gl::P ? x - gl::P : x; }

// one item's staged values: word w (value w / 2, re then im) at p[w * stride]
struct Values {
    uint64_t* p;
    int64_t stride;
    __device__ __forceinline__ Ext get(int j) const { return {p[2 * j * stride], p[(2 * j + 1) * stride]}; }
    __device__ __forceinline__ void set(int j, Ext e) const {
        p[2 * j * stride] = e.re;
        p[(2 * j + 1) * stride] = e.im;
    }
};

// y'_k = sum_j omega^(-jk) v_(rev j) in place: values in bit-reversed order in, natural order out;
// tw[m] = omega^(-m), m < A / 2
__device__ __forceinline__ void inverse_dft(const Values& v, const uint64_t* tw, int bits) {
    for (int s = 0; s < bits; ++s) {
        const int h = 1 << s, shift = bits - 1 - s;  // span 2h; twiddle of butterfly j: omega^(-j A / (2h))
        for (int m = 0; m < 1 << (bits - 1); ++m) {
            const int j = m & (h - 1), lo = ((m >> s) << (s + 1)) | j, hi = lo + h;
            const Ext u = v.get(lo);
            Ext w = v.get(hi);
            if (j) w = gl::escale(tw[j << shift], w);
            v.set(lo, gl::eadd(u, w));
            v.set(hi, gl::esub(u, w));
        }
    }
}

__device__ __forceinline__ void fold_item(const Values& v, const uint64_t* tw, const FoldStep& a, int bits, int64_t b, int64_t q,
                                          int64_t i, int64_t per_step) {
    const uint64_t oi = a.off_inv[b * a.o_row + q * a.o_query];
    const Ext beta = {a.beta_re[b * a.beta_stride], a.beta_im[b * a.beta_stride]};
    inverse_dft(v, tw, bits);
    const gl::Point c = gl::point(gl::escale(oi, beta));
    Ext acc = {0, 0};
    for (int k = (1 << bits) - 1; k >= 0; --k) acc = gl::eadd(v.get(k), gl::emul(c, acc));
    a.out[i] = gl::mul(a.inv_arity, acc.re);
    a.out[per_step + i] = gl::mul(a.inv_arity, acc.im);
}

__global__ void __launch_bounds__(FOLD_ITEMS) coset_fold_kernel(const __grid_constant__ FoldGroup g) {
    extern __shared__ uint64_t vals[];  // the shared form: (2A, FOLD_ITEMS + 1) words
    __shared__ int64_t item_at[FOLD_ITEMS];  // where each item's values start in evals
    __shared__ uint64_t tw[1 << (FOLD_SHARED_MAX_BITS - 1)];
    const int s = (int)(blockIdx.x / (unsigned)g.blocks_a_step);
    const FoldStep& a = g.step[s];  // read where it lies in the grid-constant table
    const int bits = a.arity_bits, words = 2 << bits;
    const int64_t first = ((int64_t)blockIdx.x - s * g.blocks_a_step) * FOLD_ITEMS;
    const int n = g.per_step - first < FOLD_ITEMS ? (int)(g.per_step - first) : FOLD_ITEMS;  // this block's items
    const int t = threadIdx.x;
    const int64_t i = first + min(t, n - 1);
    const unsigned q32 = (unsigned)i % (unsigned)g.queries;  // i < 2^31
    const int64_t b = ((unsigned)i - q32) / (unsigned)g.queries, q = q32;
    if (bits <= FOLD_SHARED_MAX_BITS) {  // the step's form: every thread of the block alike
        item_at[t] = b * a.e_row + q * a.e_query;
        if (t < words >> 2) tw[t] = a.idft[(1 << bits) + t];  // row 1
        __syncthreads();
        for (int k = t; k < n * words; k += FOLD_ITEMS) {
            const int item = k >> (bits + 1), w = k & (words - 1);
            vals[w * (FOLD_ITEMS + 1) + item] = canonical(a.evals[item_at[item] + w]);
        }
        __syncthreads();
        if (t < n) fold_item({vals + t, FOLD_ITEMS + 1}, tw, a, bits, b, q, i, g.per_step);
    } else if (t < n) {
        const uint64_t* src = a.evals + b * a.e_row + q * a.e_query;
        const Values v = {a.scratch + i, g.per_step};
        for (int w = 0; w < words; ++w) v.p[w * v.stride] = canonical(src[w]);
        fold_item(v, a.idft + (1 << bits), a, bits, b, q, i, g.per_step);
    }
}

}  // namespace

// `count` steps (a host array of FoldStep), each over the same (batch,
// queries) lanes, in one launch.
extern "C" int p2v_coset_fold(const void* steps, int count, int64_t batch, int64_t queries, void* stream) {
    if (count < 0 || count > FOLD_MAX_STEPS || batch < 0 || queries < 0) return (int)cudaErrorInvalidValue;
    if (batch > 0 && queries > INT32_MAX / batch) return (int)cudaErrorInvalidValue;
    FoldGroup g = {};
    g.queries = queries > 0 ? queries : 1;
    g.per_step = batch * queries;
    g.blocks_a_step = (g.per_step + FOLD_ITEMS - 1) / FOLD_ITEMS;
    if (g.per_step * count >= INT32_MAX) return (int)cudaErrorInvalidValue;
    const FoldStep* step = (const FoldStep*)steps;
    int shared_bits = -1;  // the largest arity bits of a step in the shared form
    for (int k = 0; k < count; ++k) {
        const int bits = step[k].arity_bits;
        if (bits < 0 || bits > FOLD_MAX_ARITY_BITS) return (int)cudaErrorInvalidValue;
        if (bits <= FOLD_SHARED_MAX_BITS) {
            shared_bits = bits > shared_bits ? bits : shared_bits;
        } else if (step[k].scratch == nullptr) {
            return (int)cudaErrorInvalidValue;
        }
        g.step[k] = step[k];
    }
    if (g.per_step > 0 && count > 0) {
        const size_t bytes = shared_bits < 0 ? 0 : (size_t)8 * (2 << shared_bits) * (FOLD_ITEMS + 1);  // <= 33,280: no opt-in
        const unsigned blocks = (unsigned)(g.blocks_a_step * count);
        coset_fold_kernel<<<blocks, FOLD_ITEMS, bytes, (cudaStream_t)stream>>>(g);
    }
    return (int)cudaGetLastError();
}
