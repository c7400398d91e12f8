// The verifier's field glue as three kernels: the extension Horner sum, the
// inversion and the exponentiations, the last two also in the grouped form
// that a verifier's forward launches once each (p2v_inv_grouped,
// p2v_pow_grouped; below).
//
// None replaces a Pallas kernel: the JAX package compiles the same
// functions with jax.jit into loops on the device --
//   horner_ext / horner_scaled  plonky2_verifier_tpu/verifier_jax.py:45 / :62
//                               (a lax.scan over the last axis),
//   inv                         plonky2_verifier_tpu/ops/field.py:264
//                               (an LSB-first square-and-multiply scan),
//   pow_dynamic / ext_pow_const plonky2_verifier_tpu/ops/field.py:413 / :399
//                               (a scan over the exponent's bits; an
//                               unrolled square-and-multiply).
// Run eagerly as plain PyTorch they were a chain of ~280 launches a Horner
// column, 5,876 a Fermat inversion, ~1,500 a pow_dynamic of 15 bits and
// ~3,000 an ext_pow_const(zeta, 4096): most of a verifier call's launches.
//
// p2v_horner: out[n] = sum_k point[n]^k values[n, k] in F_p[X]/(X^2 - 7),
// bit for bit what the plain version's Horner chain from zero gives,
//   acc = add(values[n, k], emul(point[n], acc))   for k = K-1 ... 0,
// also where words >= p are among the values (proof words): see below and
// goldilocks.cuh. Two template flags drop the imaginary part that is zero:
// BASE_VALUES (one word a value, never a zero tensor; combineInitial's leaf
// rows) and BASE_POINT (emul with im = 0 is escale: add(x, 0) = x for the
// canonical products, so 2 products a step; horner_scaled and the final
// polynomial). Values row = n / v_rep and point row = n / p_rep: a row that
// the caller broadcasts (a stride-0 `expand`) is read where it lies, never
// copied. Values are (rows, K) at any row and column stride in words, the
// real and imaginary parts at one stride pattern (the interleaved openings
// have column stride 2).
//
// Bound: integer ALU work, the least that the steps below need a value: 4
// products and 4 adds with an extension point, 3 products and 2.5 adds with
// base-field values (two values a step), 2 and 2 with a base-field point,
// 1 and 1 with both base-field; a product is 16 int32 instructions and an
// add 4, as W counts them in poseidon.cuh (chip_smoke.horner_work). At
// combineInitial's shape (28,672 rows x 254 base-field values) that is
// 0.025 ms on the H100 against 0.017 ms to read the 58 MB of values.
//
// Design: a row's chain is sequential, and one thread a row (the first
// form of this kernel) left ~7 warps an SM at combineInitial and one warp
// on each of 32 SMs at the reduced openings (1,024 rows): bound by the
// latency of its chain. So a row is split into S segments (S a power of
// two up to 32, picked by the wrapper from the rows and K: kernels.
// horner_segments), a thread each, on neighbouring lanes of one warp.
// Segment s takes the columns s, s + S, s + 2S, ..., so that the S threads
// of a row read S neighbouring columns with one load instruction (256
// contiguous bytes at S = 32 and column stride 1), and runs their Horner
// sum in q = point^S from zero:
//   H_s = sum_m q^m values[n, s + m S],   out[n] = sum_s point^s H_s.
// The second sum is a tree over the segments by warp shuffles: at level j
// a row's lane s (a multiple of 2^(j+1)) adds point^(2^j) times lane
// s + 2^j's value; point^(2^j) comes by squaring (before the sums to make
// q, again in the tree: fewer registers, so more threads an SM).
// A segment's first step may lie past K: it adds 0 to 0.
//
// Why the bits are the plain version's: every product is canonical
// (goldilocks.cuh), and `add` with one canonical operand is exact and
// canonical for any u64 word. Every step of the plain chain is
// add(value, product), so the plain output is the canonical representative
// of sum_k point^k values[n, k], also for values and points x + p. Every add
// here has a canonical product as one operand too (a segment's steps), or
// two canonical operands (the tree), so the output is the same exact sum,
// canonical: the same word. A step's product by q takes four products, not
// emul's five: q's 7 q.im is formed once (goldilocks.cuh, Point); with
// BASE_VALUES a step takes two values, acc = v[m - 1] + q v[m] + q^2 acc
// (3 products a value: q v[m] is two, v being a base-field word). The adds
// of that step have canonical operands but the last, add(v[m - 1], .):
// the same exact sum, the same word. With BASE_VALUES the imaginary part of a step
// is the product's, as add(0, e.im) gives it. tools/check_field_kernels.py
// holds every segment count against the plain version and golden/, and
// its horner_split_plain is this order in PyTorch (tests/test_torch_glue.py
// holds it equal to the plain order on the CPU).
//
// p2v_inv: a^(p - 2) elementwise, inv(0) = 0 (the JAX convention). Any
// addition chain gives the plain version's bits: every product is
// canonical, and the chain below multiplies by the input first, so an input
// >= p is reduced by its first product as the plain chain reduces it.
// p - 2 = 2^64 - 2^32 - 1 in 63 squarings and 9 products (the plain
// version's square-and-multiply spends 125). Elementwise and tiny at the
// verifier's shapes (28,672 words): launch-bound; what it removes is the
// plain chain's 5,876 launches.
//
// p2v_pow: base^e elementwise by LSB-first square-and-multiply from
// acc = 1, as pow_dynamic_plain computes it. Two template flags: EXT (an
// extension base, emul for every product; else base-field mul) and DYNAMIC
// (an int64 exponent an element, below 2^n_bits: pow_dynamic; else one
// exponent e from the host: ext_pow_const). Exponent bits at and above
// n_bits are not read, as in the plain scan. Bits: acc starts canonical (1)
// and every product is canonical, so e = 0 gives 1 and any other exponent
// gives the canonical base^e, for a base word >= p too (its first product
// reduces it). pow_dynamic_plain gives the same bits; ext_pow_const_plain
// does for e >= 2 (its e = 1 returns the input's own bits and its e = 0 is
// (1, 0): the wrapper, ops/field.ext_pow_const, answers both on the host
// without a launch). Base row = i / b_rep at a stride of b_stride words: a
// base broadcast by `expand` (a stride-0 axis, a scalar) is read where it
// lies. Bound: integer ALU work, n_bits - 1 squarings and a product a set
// bit (an emul is 5 products and 2 adds); elementwise, no reuse, so at the
// verifier's (1024, 28) launch-bound.
//
// p2v_inv and p2v_pow stay the entry points of ops/field.inv, pow_dynamic and
// ext_pow_const for tools and tests. The verifier's forward makes one call of
// each of the two grouped kernels below instead (verifier_torch.
// TorchVerifier._powers_and_inverses): every exponent of a forward is a
// function of the transcript's output (zeta, alpha and the query indices),
// and every denominator one of zeta and those powers, so both gather at one
// place right after the transcript. One call each was five inversions and
// six exponentiations a forward: 11 calls of the host's wrapper (0.03-0.10 ms
// each) for ~0.05 ms of device work.
//
// p2v_pow_grouped: the powers of a forward from a segment table passed by
// value (PowGroup, as p2v_sponge_rows_grouped passes its table), a thread an
// element. Two kinds of segment:
// - GEN, factor * g^e for a fixed generator g and an exponent an element,
//   e = bit_reverse over `bits` bits of (idx >> shift) with its `clear` low
//   bits cleared, idx the query index of the element's (row, column): the
//   exponent is derived here as the call site derives it, no exponent tensor
//   is made. The product runs over a table of g^(2^k), k < bits (canonical,
//   built on the host from golden/field.py's ints and placed on the card when
//   the verifier is built): popcount(e) products from acc = factor, no
//   squaring (the table's 2^k powers are what square-and-multiply squares its
//   way to, in every thread).
// - EXT, base^e for an extension base a row and one exponent e >= 2 from the
//   host: p2v_pow's square-and-multiply (zeta^n, alpha^(n_zs + n_lookup)).
// Bits: a canonical power is unique, so the order of the products cannot
// change a word: acc starts canonical (factor, 1) and every product is
// canonical, for a base word >= p too (its first product reduces it). GEN
// gives mul(factor, pow_dynamic_plain(g, e)) (e = 0: the factor), EXT gives
// ext_pow_const_plain for e >= 2 (e = 0 and 1 are the host's, no launch).
// Bound: integer ALU work, popcount(e) products a GEN element and
// p2v_pow's emuls an EXT row; the query indices read once, each output
// written once (chip_smoke.pow_grouped_work).
//
// p2v_inv_grouped: a^(p - 2) elementwise with inv(0) = 0 by Montgomery's
// batch trick. A thread takes a group of INV_GROUP words, i, i + T, i + 2T,
// ... (T = the threads, so a warp reads neighbouring words at each step),
// forms their prefix products, inverts the group's product by the Fermat
// chain of p2v_inv (72 products), and sweeps back: a word's inverse is the
// running inverse times the prefix before it, and the running inverse then
// takes the word in (2 products). 3 products a word and 72 a group, not 72
// a word. A word that is 0 mod p (0, or p itself: the only word x + p that
// is) enters the products as 1 and is written as 0; the padding past n
// enters as 1. Bits: an inverse is unique and every product canonical (a
// first prefix word >= p is reduced by the product that reads it, or by the
// chain's first product), so each word is inv_plain's. Bound: integer ALU
// work, 72 products a group and 3 a word past the group's first (the
// least that these steps need; chip_smoke.inv_grouped_work), against p2v_inv's
// 72 a word.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

using gl::Ext;

namespace {

constexpr int HORNER_THREADS = 256;
constexpr int INV_THREADS = 256;
constexpr int INV_GROUP = 8;  // words a thread of p2v_inv_grouped (kernels.INV_GROUP)
// p2v_inv_grouped's block: a forward's 14,464 threads make 226 blocks, one or two on each of the 132
// SMs (blocks of 256 left 75 SMs without one)
constexpr int INV_GROUPED_THREADS = 64;
constexpr int POW_MAX_SEGMENTS = 16;  // segments a launch of p2v_pow_grouped (kernels.POW_MAX_SEGMENTS)

struct HornerArgs {
    const uint64_t* v_re;
    const uint64_t* v_im;  // unused with BASE_VALUES
    const uint64_t* p_re;
    const uint64_t* p_im;  // unused with BASE_POINT
    uint64_t* out_re;
    uint64_t* out_im;
    int64_t n, k;
    int64_t v_row, v_col, v_rep;  // strides in words; values row = n / v_rep
    int64_t p_stride, p_rep;      // point row = n / p_rep
    int seg_bits;                 // S = 2^seg_bits segments a row, S <= 32
};

template <bool BASE_POINT>
__device__ __forceinline__ Ext times(Ext x, Ext y) {  // x * y, x of the point's field
    if constexpr (BASE_POINT) {
        return {gl::mul(x.re, y.re), gl::mul(x.re, y.im)};
    } else {
        return gl::emul(x, y);
    }
}

template <bool BASE_POINT>
__device__ __forceinline__ Ext times(gl::Point x, Ext y) {  // the same, x's 7 im formed once
    if constexpr (BASE_POINT) {
        return {gl::mul(x.re, y.re), gl::mul(x.re, y.im)};
    } else {
        return gl::emul(x, y);
    }
}

template <bool BASE_VALUES, bool BASE_POINT>
__global__ void __launch_bounds__(HORNER_THREADS) horner_kernel(const HornerArgs a) {
    const int64_t t = (int64_t)blockIdx.x * HORNER_THREADS + threadIdx.x;
    const int S = 1 << a.seg_bits;
    const int s = (int)(t & (S - 1));
    int64_t n = t >> a.seg_bits;
    const bool live = n < a.n;
    if (!live) n = a.n - 1;  // a copy of the last row: the shuffles below take every lane of a warp

    const int64_t p_at = n / a.p_rep * a.p_stride;
    const Ext point = {a.p_re[p_at], BASE_POINT ? 0 : a.p_im[p_at]};
    Ext q = point;  // point^S; the tree below squares its way up again rather than hold point^(2^j) in registers
    for (int j = 0; j < a.seg_bits; ++j) q = times<BASE_POINT>(q, q);
    const gl::Point qp = gl::point(q);
    const int64_t row = n / a.v_rep * a.v_row;
    const int64_t steps = (a.k + S - 1) >> a.seg_bits;
    // the segment's m-th value (a first step past K reads 0) and where it lies
    auto at = [&](int64_t m) { const int64_t col = s + (m << a.seg_bits); return col < a.k ? row + col * a.v_col : -1; };
    Ext acc = {0, 0};
    int64_t m = steps - 1;
    if constexpr (BASE_VALUES) {
        // two values a step: acc = v[m - 1] + q v[m] + q^2 acc, with q v[m] two products (one with a
        // base-field point) for a base-field value, so 3 products a value where a step of one takes 4
        if (steps & 1) {
            const int64_t i = at(m--);
            acc.re = gl::add(i >= 0 ? a.v_re[i] : 0, 0);
        }
        const gl::Point q2 = gl::point(times<BASE_POINT>(q, q));
        for (; m >= 1; m -= 2) {
            const int64_t i = at(m), j = at(m - 1);
            const uint64_t hi = i >= 0 ? a.v_re[i] : 0, lo = j >= 0 ? a.v_re[j] : 0;
            const Ext e = times<BASE_POINT>(q2, acc);
            acc.im = BASE_POINT ? e.im : gl::add(gl::mul(q.im, hi), e.im);
            acc.re = gl::add(lo, gl::add(gl::mul(q.re, hi), e.re));
        }
    } else {
        for (; m >= 0; --m) {
            const int64_t i = at(m);
            const Ext e = times<BASE_POINT>(qp, acc);
            acc.re = gl::add(i >= 0 ? a.v_re[i] : 0, e.re);
            acc.im = gl::add(i >= 0 ? a.v_im[i] : 0, e.im);
        }
    }
    Ext pw = point;  // point^(2^j) at level j
    for (int j = 0; j < a.seg_bits; ++j) {  // seg_bits is one value for the whole grid: every lane shuffles alike
        const Ext o = {(uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)acc.re, 1 << j, S),
                       (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)acc.im, 1 << j, S)};
        const Ext e = times<BASE_POINT>(pw, o);
        acc = {gl::add(acc.re, e.re), gl::add(acc.im, e.im)};
        pw = times<BASE_POINT>(pw, pw);
    }
    if (live && s == 0) {
        a.out_re[n] = acc.re;
        a.out_im[n] = acc.im;
    }
}

__device__ __forceinline__ uint64_t squarings(uint64_t x, int count) {
    for (int i = 0; i < count; ++i) x = gl::mul(x, x);
    return x;
}

// a^(p - 2) by 63 squarings and 9 products, the input multiplied in first
__device__ __forceinline__ uint64_t fermat_inverse(uint64_t a) {
    // t_k = a^(2^k - 1)
    const uint64_t t2 = gl::mul(gl::mul(a, a), a);
    const uint64_t t3 = gl::mul(gl::mul(t2, t2), a);
    const uint64_t t6 = gl::mul(squarings(t3, 3), t3);
    const uint64_t t12 = gl::mul(squarings(t6, 6), t6);
    const uint64_t t24 = gl::mul(squarings(t12, 12), t12);
    const uint64_t t30 = gl::mul(squarings(t24, 6), t6);
    const uint64_t t31 = gl::mul(gl::mul(t30, t30), a);
    const uint64_t t63 = gl::mul(squarings(t31, 32), t31);  // a^(2^63 - 2^31 - 1)
    return gl::mul(gl::mul(t63, t63), a);                    // a^(2^64 - 2^32 - 1) = a^(p - 2)
}

__global__ void inv_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) out[i] = fermat_inverse(in[i]);
}

// groups = ceil(n / INV_GROUP) threads; thread t takes the words t + j groups
__global__ void __launch_bounds__(INV_GROUPED_THREADS) inv_grouped_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                                                          int64_t n, int64_t groups) {
    const int64_t t = (int64_t)blockIdx.x * INV_GROUPED_THREADS + threadIdx.x;
    if (t >= groups) return;
    uint64_t a[INV_GROUP], c[INV_GROUP];  // the words (0 mod p and padding as 1), their prefix products
    unsigned zero = 0;
#pragma unroll
    for (int j = 0; j < INV_GROUP; ++j) {
        const int64_t i = t + j * groups;
        uint64_t x = i < n ? in[i] : 1;
        if (x == 0 || x == gl::P) {
            zero |= 1u << j;
            x = 1;
        }
        a[j] = x;
        if (j == 0) {
            c[0] = x;
        } else {
            c[j] = gl::mul(c[j - 1], x);
        }
    }
    uint64_t u = fermat_inverse(c[INV_GROUP - 1]);  // (a_0 ... a_j)^-1 at step j below
#pragma unroll
    for (int j = INV_GROUP - 1; j >= 1; --j) {
        const int64_t i = t + j * groups;
        const uint64_t r = gl::mul(u, c[j - 1]);
        u = gl::mul(u, a[j]);
        if (i < n) out[i] = (zero >> j) & 1 ? 0 : r;
    }
    out[t] = zero & 1 ? 0 : u;  // t < groups <= n
}

struct PowArgs {
    const uint64_t* b_re;
    const uint64_t* b_im;  // EXT only
    const int64_t* exps;   // DYNAMIC only: (n,)
    uint64_t* out_re;
    uint64_t* out_im;  // EXT only
    int64_t n, b_stride, b_rep;  // base row = i / b_rep, at b_stride words a row
    uint64_t e;                  // !DYNAMIC
    int n_bits;
};

template <bool EXT, bool DYNAMIC>
__global__ void pow_kernel(const PowArgs a) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
        const int64_t at = i / a.b_rep * a.b_stride;
        Ext s = {a.b_re[at], EXT ? a.b_im[at] : 0};
        const uint64_t e = DYNAMIC ? (uint64_t)a.exps[i] : a.e;
        Ext acc = {1, 0};
        for (int k = 0; k < a.n_bits; ++k) {
            if ((e >> k) & 1) {
                if constexpr (EXT) {
                    acc = gl::emul(acc, s);
                } else {
                    acc.re = gl::mul(acc.re, s.re);
                }
            }
            if (k + 1 < a.n_bits) {
                if constexpr (EXT) {
                    s = gl::emul(s, s);
                } else {
                    s.re = gl::mul(s.re, s.re);
                }
            }
        }
        a.out_re[i] = acc.re;
        if constexpr (EXT) a.out_im[i] = acc.im;
    }
}

// One segment of p2v_pow_grouped; kernels.PowSegment field for field.
struct PowSegment {
    uint64_t* out;          // GEN: n words; EXT: n real parts, then n imaginary parts
    const uint64_t* b_re;   // EXT: row i of the base at i * b_stride words
    const uint64_t* b_im;
    const uint64_t* table;  // GEN: g^(2^k) for k < bits, canonical
    uint64_t e;             // EXT: the exponent, >= 2
    uint64_t factor;        // GEN: canonical
    int64_t n;              // elements
    int64_t b_stride;       // EXT
    int32_t ext;            // 1: EXT, 0: GEN
    int32_t bits;           // GEN: e = bit_reverse over `bits` bits of ((idx >> shift) >> clear << clear)
    int32_t shift;
    int32_t clear;
};

struct PowGroup {
    PowSegment seg[POW_MAX_SEGMENTS];
    int64_t first[POW_MAX_SEGMENTS];  // a segment's first thread; INT64_MAX for an unused slot
    const int64_t* idx;               // GEN: element i reads idx[(i / q) * idx_row + i % q] (idx[i] where idx_row == q)
    int64_t idx_row, q, total;        // total < 2^31
};

__global__ void __launch_bounds__(INV_THREADS) pow_grouped_kernel(const __grid_constant__ PowGroup g) {
    const int64_t t = (int64_t)blockIdx.x * INV_THREADS + threadIdx.x;
    if (t >= g.total) return;
    // the segment of thread t: the segments that start at or before it, less one
    // (they start in order); read where it lies in the grid-constant table, no copy
    int s = 0;
#pragma unroll
    for (int k = 1; k < POW_MAX_SEGMENTS; ++k) s += t >= g.first[k];
    const PowSegment& a = g.seg[s];
    const int64_t i = t - g.first[s];
    if (a.ext) {
        Ext s = {a.b_re[i * a.b_stride], a.b_im[i * a.b_stride]};
        Ext acc = {1, 0};
        for (uint64_t e = a.e;;) {  // LSB first, as p2v_pow
            if (e & 1) acc = gl::emul(acc, s);
            e >>= 1;
            if (!e) break;
            s = gl::emul(s, s);
        }
        a.out[i] = acc.re;
        a.out[a.n + i] = acc.im;
    } else {
        int64_t at = i;  // contiguous indices: no division
        if (g.idx_row != g.q) {
            const uint32_t row = (uint32_t)i / (uint32_t)g.q;
            at = (int64_t)row * g.idx_row + ((uint32_t)i - row * (uint32_t)g.q);
        }
        const uint64_t x = (uint64_t)g.idx[at] >> a.shift >> a.clear << a.clear;
        uint64_t e = a.bits ? __brevll(x) >> (64 - a.bits) : 0;
        uint64_t acc = a.factor;
        while (e) {
            acc = gl::mul(acc, a.table[__ffsll((long long)e) - 1]);
            e &= e - 1;
        }
        a.out[i] = acc;
    }
}

}  // namespace

extern "C" int p2v_horner(const void* v_re, const void* v_im, const void* p_re, const void* p_im, void* out_re,
                          void* out_im, int64_t n, int64_t k, int64_t v_row, int64_t v_col, int64_t v_rep,
                          int64_t p_stride, int64_t p_rep, int seg_bits, void* stream) {
    if (seg_bits < 0 || seg_bits > 5) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const HornerArgs a = {(const uint64_t*)v_re, (const uint64_t*)v_im, (const uint64_t*)p_re,
                              (const uint64_t*)p_im, (uint64_t*)out_re, (uint64_t*)out_im, n, k, v_row,
                              v_col, v_rep, p_stride, p_rep, seg_bits};
        const unsigned blocks = (unsigned)(((n << seg_bits) + HORNER_THREADS - 1) / HORNER_THREADS);
        cudaStream_t s = (cudaStream_t)stream;
        const bool base_values = v_im == nullptr, base_point = p_im == nullptr;
        if (base_values && base_point) {
            horner_kernel<true, true><<<blocks, HORNER_THREADS, 0, s>>>(a);
        } else if (base_values) {
            horner_kernel<true, false><<<blocks, HORNER_THREADS, 0, s>>>(a);
        } else if (base_point) {
            horner_kernel<false, true><<<blocks, HORNER_THREADS, 0, s>>>(a);
        } else {
            horner_kernel<false, false><<<blocks, HORNER_THREADS, 0, s>>>(a);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int p2v_inv(const void* in, void* out, int64_t n, void* stream) {
    if (n > 0) {
        const int64_t blocks = (n + INV_THREADS - 1) / INV_THREADS;
        inv_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), INV_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint64_t*)in, (uint64_t*)out, n);
    }
    return (int)cudaGetLastError();
}

extern "C" int p2v_pow(const void* b_re, const void* b_im, const void* exps, void* out_re, void* out_im, int64_t n,
                       int64_t b_stride, int64_t b_rep, uint64_t e, int n_bits, void* stream) {
    if (n > 0) {
        const PowArgs a = {(const uint64_t*)b_re, (const uint64_t*)b_im, (const int64_t*)exps, (uint64_t*)out_re,
                           (uint64_t*)out_im, n, b_stride, b_rep, e, n_bits};
        const int64_t want = (n + INV_THREADS - 1) / INV_THREADS;
        const unsigned blocks = (unsigned)(want < 65535 ? want : 65535);
        cudaStream_t s = (cudaStream_t)stream;
        const bool ext = b_im != nullptr, dynamic = exps != nullptr;
        if (ext && dynamic) {
            pow_kernel<true, true><<<blocks, INV_THREADS, 0, s>>>(a);
        } else if (ext) {
            pow_kernel<true, false><<<blocks, INV_THREADS, 0, s>>>(a);
        } else if (dynamic) {
            pow_kernel<false, true><<<blocks, INV_THREADS, 0, s>>>(a);
        } else {
            pow_kernel<false, false><<<blocks, INV_THREADS, 0, s>>>(a);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int p2v_inv_grouped(const void* in, void* out, int64_t n, void* stream) {
    if (n > 0) {
        const int64_t groups = (n + INV_GROUP - 1) / INV_GROUP;
        const unsigned blocks = (unsigned)((groups + INV_GROUPED_THREADS - 1) / INV_GROUPED_THREADS);
        inv_grouped_kernel<<<blocks, INV_GROUPED_THREADS, 0, (cudaStream_t)stream>>>((const uint64_t*)in, (uint64_t*)out, n, groups);
    }
    return (int)cudaGetLastError();
}

// `count` segments (a host array) in one launch; idx the query indices of
// the GEN segments, (rows, q) at idx_row words a row.
extern "C" int p2v_pow_grouped(const void* segments, int count, const void* idx, int64_t idx_row, int64_t q, void* stream) {
    if (count < 0 || count > POW_MAX_SEGMENTS || q < 0) return (int)cudaErrorInvalidValue;
    PowGroup g = {};
    const PowSegment* seg = (const PowSegment*)segments;
    int64_t total = 0;
    for (int k = 0; k < POW_MAX_SEGMENTS; ++k) {
        g.first[k] = k < count ? total : INT64_MAX;
        if (k < count) {
            g.seg[k] = seg[k];
            if (seg[k].n < 0 || seg[k].bits < 0 || seg[k].bits > 64 || (!seg[k].ext && q == 0 && seg[k].n > 0))
                return (int)cudaErrorInvalidValue;
            total += seg[k].n;
        }
    }
    if (total >= INT32_MAX) return (int)cudaErrorInvalidValue;  // 32-bit index arithmetic
    g.idx = (const int64_t*)idx;
    g.idx_row = idx_row;
    g.q = q > 0 ? q : 1;
    g.total = total;
    if (total > 0) {
        const unsigned blocks = (unsigned)((total + INV_THREADS - 1) / INV_THREADS);
        pow_grouped_kernel<<<blocks, INV_THREADS, 0, (cudaStream_t)stream>>>(g);
    }
    return (int)cudaGetLastError();
}
