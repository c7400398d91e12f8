// The verifier's field glue as three kernels: the extension Horner sum, the
// Fermat inversion and the exponentiations.
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
// Horner from zero in the plain version's order,
//   acc = add(values[n, k], emul(point[n], acc))   for k = K-1 ... 0,
// so that words >= p among the values (proof words) give the plain bits
// (goldilocks.cuh). Two template flags drop the imaginary part that is zero:
// BASE_VALUES (one word a value, never a zero tensor; combineInitial's leaf
// rows) and BASE_POINT (emul with im = 0 is escale: add(x, 0) = x for the
// canonical products, so 2 products a step; horner_scaled and the final
// polynomial). Values row = n / v_rep and point row = n / p_rep: a row that
// the caller broadcasts (a stride-0 `expand`) is read where it lies, never
// copied. Values are (rows, K) at any row and column stride in words, the
// real and imaginary parts at one stride pattern (the interleaved openings
// have column stride 2).
//
// Bound: integer ALU work. A step is 5 products and up to 4 adds (2 and up
// to 2 with a base-field point); a product is 16 int32 instructions and an
// add 4, as W counts them in poseidon.cuh. At combineInitial's shape
// (28,672 rows x 254 base-field values) that is 0.040 ms on the H100 against
// 0.017 ms to read the 58 MB of values. Design: a row's chain is sequential,
// so one thread a row, in the plain order. The loads are what is designed:
// a block is one warp of 32 rows; it stages 32 columns of its 32 rows at a
// time into shared memory, each load instruction of the warp reading 32
// neighbouring columns of one row (256 contiguous bytes at column stride
// 1), then each thread runs its row's chain over the chunk from shared
// memory (row pitch 33 words: a warp's reads of one column fall in distinct
// banks). 17 KB a block; 28,672 rows are 896 blocks, one wave.
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
#include <cuda_runtime.h>

#include "goldilocks.cuh"

using gl::Ext;

namespace {

constexpr int ROWS = 32;   // rows a block, one a thread
constexpr int CHUNK = 32;  // columns staged at a time
constexpr int INV_THREADS = 256;

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
};

template <bool BASE_VALUES, bool BASE_POINT>
__global__ void __launch_bounds__(ROWS) horner_kernel(const HornerArgs a) {
    __shared__ uint64_t s_re[ROWS][CHUNK + 1];
    __shared__ uint64_t s_im[BASE_VALUES ? 1 : ROWS][CHUNK + 1];
    __shared__ int64_t s_off[ROWS];  // each row's first value, in words
    const int lane = threadIdx.x;
    const int64_t row0 = (int64_t)blockIdx.x * ROWS;
    const int64_t n = row0 + lane;
    const bool live = n < a.n;
    const int64_t left = a.n - row0;
    const int rows = left < ROWS ? (int)left : ROWS;

    Ext point = {0, 0};
    if (live) {
        const int64_t at = n / a.p_rep * a.p_stride;
        point.re = a.p_re[at];
        if constexpr (!BASE_POINT) point.im = a.p_im[at];
        s_off[lane] = n / a.v_rep * a.v_row;
    }
    Ext acc = {0, 0};
    for (int64_t end = a.k; end > 0; end -= CHUNK) {
        const int64_t start = end > CHUNK ? end - CHUNK : 0;
        const int width = (int)(end - start);
        __syncwarp();  // the previous chunk is consumed, s_off is written
        if (lane < width) {
            const int64_t col = (start + lane) * a.v_col;
            for (int r = 0; r < rows; ++r) {
                s_re[r][lane] = a.v_re[s_off[r] + col];
                if constexpr (!BASE_VALUES) s_im[r][lane] = a.v_im[s_off[r] + col];
            }
        }
        __syncwarp();
        if (live) {
            for (int j = width - 1; j >= 0; --j) {
                Ext e;
                if constexpr (BASE_POINT) {
                    e = {gl::mul(point.re, acc.re), gl::mul(point.re, acc.im)};
                } else {
                    e = gl::emul(point, acc);
                }
                acc.re = gl::add(s_re[lane][j], e.re);
                if constexpr (BASE_VALUES) {
                    acc.im = e.im;  // add(0, e.im) for the canonical e.im
                } else {
                    acc.im = gl::add(s_im[lane][j], e.im);
                }
            }
        }
    }
    if (live) {
        a.out_re[n] = acc.re;
        a.out_im[n] = acc.im;
    }
}

__device__ __forceinline__ uint64_t squarings(uint64_t x, int count) {
    for (int i = 0; i < count; ++i) x = gl::mul(x, x);
    return x;
}

__global__ void inv_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const uint64_t a = in[i];
        // t_k = a^(2^k - 1)
        const uint64_t t2 = gl::mul(gl::mul(a, a), a);
        const uint64_t t3 = gl::mul(gl::mul(t2, t2), a);
        const uint64_t t6 = gl::mul(squarings(t3, 3), t3);
        const uint64_t t12 = gl::mul(squarings(t6, 6), t6);
        const uint64_t t24 = gl::mul(squarings(t12, 12), t12);
        const uint64_t t30 = gl::mul(squarings(t24, 6), t6);
        const uint64_t t31 = gl::mul(gl::mul(t30, t30), a);
        const uint64_t t63 = gl::mul(squarings(t31, 32), t31);  // a^(2^63 - 2^31 - 1)
        out[i] = gl::mul(gl::mul(t63, t63), a);                  // a^(2^64 - 2^32 - 1) = a^(p - 2)
    }
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

}  // namespace

extern "C" int p2v_horner(const void* v_re, const void* v_im, const void* p_re, const void* p_im, void* out_re,
                          void* out_im, int64_t n, int64_t k, int64_t v_row, int64_t v_col, int64_t v_rep,
                          int64_t p_stride, int64_t p_rep, void* stream) {
    if (n > 0) {
        const HornerArgs a = {(const uint64_t*)v_re, (const uint64_t*)v_im, (const uint64_t*)p_re,
                              (const uint64_t*)p_im, (uint64_t*)out_re, (uint64_t*)out_im, n, k, v_row,
                              v_col, v_rep, p_stride, p_rep};
        const unsigned blocks = (unsigned)((n + ROWS - 1) / ROWS);
        cudaStream_t s = (cudaStream_t)stream;
        const bool base_values = v_im == nullptr, base_point = p_im == nullptr;
        if (base_values && base_point) {
            horner_kernel<true, true><<<blocks, ROWS, 0, s>>>(a);
        } else if (base_values) {
            horner_kernel<true, false><<<blocks, ROWS, 0, s>>>(a);
        } else if (base_point) {
            horner_kernel<false, true><<<blocks, ROWS, 0, s>>>(a);
        } else {
            horner_kernel<false, false><<<blocks, ROWS, 0, s>>>(a);
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
