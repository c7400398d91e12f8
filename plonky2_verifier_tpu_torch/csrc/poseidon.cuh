// Poseidon-12 over Goldilocks (p = 2^64 - 2^32 + 1), shared by the port's
// three kernels (permutation.cu, sponge.cu, merkle.cu).
//
// Replaces the round body of the TPU kernels:
//   plonky2_verifier_tpu/ops/pallas_poseidon.py  _rounds, _sbox7, _mds_rolled.
//
// What bounds it on an H100: 32-bit integer ALU work, not memory (a
// permutation moves ~200 bytes). The yardstick W counts the 32-bit integer
// instructions one permutation needs from its arithmetic alone, whatever
// kernel runs it; IMAD.WIDE.U32 (32 x 32 + 64 -> 64) counts as one.
//
//   64 x 64 -> 128 product from 32-bit halves a = (a1, a0), b = (b1, b0):
//     p00 = a0 b0;  p01 = a0 b1 + hi32(p00);  p10 = a1 b0 + lo32(p01);
//     p11 = a1 b1 + (hi32(p01) + hi32(p10))         -- none can overflow 64 bits
//     4 IMAD.WIDE + 2 (the 33-bit sum of two high words)            =  6
//   reduction mod p of (hi, lo), with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p):
//     lo - hi_hi (2), fix the borrow (2), hi_lo * (2^32 - 1) as a shift and
//     subtract (2), add (2), fix the carry (2); no final compare         = 10
//     (the carries counted as free flags; `reduce128` below spends 13,
//     three of them to turn a flag into a word)
//   modular multiply                                                     = 16
//   S-box x^7 = x^2, x^3, x^4, x^3 x^4: 4 multiplies                     = 64
//   MDS row: 12 coefficients x two 32-bit halves of the lane, IMAD.WIDE  = 24
//     join the halves (2), reduce a high word below 2^10 (6)              =  8
//   round constants: folded into the accumulators of the previous round's
//     MDS rows (an IMAD.WIDE takes its addend for nothing), so only round 0
//     pays for them: 12 adds of 4 (add, fix the carry)                   = 48
//
//   W = 118 S-boxes x 64 + 360 rows x 32 + 30 x 2 (lane 0's diagonal) + 48
//     = 7,552 + 11,520 + 60 + 48 = 19,180 instructions a permutation.
//
// At 132 SMs x 64 int32 lanes a clock and the H100's maximum SM clock of
// 1.98 GHz (nvidia-smi clocks.max.sm) that is 1.147 ns a permutation.
// chip_smoke.py computes each kernel's bound from W and the clock it reads.
// W keeps the textbook round structure
// (every partial round a full MDS). The sparse-matrix form of the partial
// rounds is reckoned no cheaper here: it trades twelve rows of coefficients
// below 2^6 (two IMAD.WIDE a term) for 23 multiplies by full-width constants.
//
// How the kernels keep near W:
// - Words stay below 2^64 but not canonical between rounds; `canonical` runs
//   once at the end of `permute`. The ranges: `reduce128` returns a word
//   below 2^64 for any (hi, lo) -- when lo - hi_hi borrows, lo < hi_hi <
//   2^32, so the wrapped difference is at least 2^64 - 2^32 + 1 and taking
//   2^32 - 1 from it cannot wrap; hi_lo (2^32 - 1) <= 2^64 - 2^33 + 1, and
//   when the add of it carries the wrapped sum is below it, so adding
//   2^32 - 1 stays below 2^64. `add_rc` needs one canonical operand (the
//   round constant): on a carry the wrapped sum is at most p - 2. So every
//   input word below 2^64, the non-canonical p and 2^64 - 1 among them,
//   gives the canonical result.
// - An MDS row sums 12 coefficients of sum 256 (+ 8 on lane 0's diagonal)
//   times words below 2^64, plus a folded constant below 2^64: below
//   265 * 2^64 < 2^73. Each lane is split into 32-bit halves and both halves
//   are accumulated in 64-bit words (< 265 * 2^32 < 2^41), so the high word
//   of the row is below 2^10 and `reduce_small` (valid for any high word
//   below 2^32) replaces the general reduction.
// - Round constants: `c_pre` is round 0's; `c_post[r]` is what round r's MDS
//   rows start their sums from. For a full round that is the next round's
//   constants. In a partial round only lane 0 passes the S-box, so the
//   constants of lanes 1-11 commute with the (linear) MDS and are carried
//   forward: c_post[r] holds lane 0's constant alone and the rest arrives,
//   multiplied through, in c_post[25] before the last four full rounds.
//   kernels.py computes both tables from golden/poseidon_constants.py.
// - In a 2-to-1 compression lanes 8-11 enter as zero: `permute<true>` starts
//   them at the constant.
//
// Two forms of the permutation:
// - `permute`: one 12-lane state per thread, in registers (every lane index
//   is a compile-time constant after unrolling); the round loop stays rolled
//   to keep the code small. The form for many states: all the work, no
//   traffic between threads.
// - `permute_split`: one state per 16-lane half of a warp, one word a thread
//   (lanes 12-15 mirror lanes 0-3), the 12 words carried to each MDS row by
//   __shfl_sync. A full round's S-boxes run in parallel; in a partial round
//   only lane 0's is kept. It spends ~4x the instructions a state
//   but cuts the serial chain a thread walks by about ten, which is what a
//   small batch (a transcript step of 1024 states) waits for.
//
// The constants are not written here: each translation unit owns a copy of
// the tables and fills it from its *_init entry point, which the Python
// loader calls.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace p2v {

constexpr int WIDTH = 12;
constexpr int N_ROUNDS = 30;
constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;  // 2^64 mod p

static __constant__ uint64_t c_pre[WIDTH];
static __constant__ uint64_t c_post[N_ROUNDS * WIDTH];
static __constant__ uint32_t c_circ[WIDTH];
static __constant__ uint32_t c_diag[WIDTH];

static int g_sms = 132;  // read from the device by upload_constants

static cudaError_t upload_constants(const void* pre, const void* post, const void* circ, const void* diag) {
    cudaError_t e = cudaMemcpyToSymbol(c_pre, pre, sizeof(c_pre));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_post, post, sizeof(c_post));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_circ, circ, sizeof(c_circ));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_diag, diag, sizeof(c_diag));
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    return e;
}

// Blocks for n items, one item a thread and a grid-stride loop beyond one
// wave. `resident` is how many blocks of the kernel one SM holds. Up to one
// wave every thread gets one item. Beyond it the grid is cut so that every
// thread walks the same number of items, k = ceil(n / a wave's threads):
// a full wave followed by a sliver would leave most SMs idle for the
// sliver's whole walk.
static unsigned balanced_grid(int64_t n, int threads, int resident) {
    const int64_t blocks = (n + threads - 1) / threads;
    const int64_t wave = (int64_t)g_sms * (resident > 0 ? resident : 1);
    if (blocks <= wave) return (unsigned)blocks;
    const int64_t k = (blocks + wave - 1) / wave;
    return (unsigned)((blocks + k - 1) / k);
}

// Field helpers. Each returns a word < 2^64 congruent to the value, not
// canonical; the ranges are argued at the top of this file.

// The reductions are written on 32-bit halves with the hardware's carry
// flag (PTX add.cc / addc, sub.cc / subc): from C the compiler builds each
// carry out of two compares and a select, about 2.5 times the instructions.
// A carry word is 0 or 1 and is negated to 0 or 0xFFFFFFFF, the low word of
// 2^32 - 1, so "add 2^32 - 1 if the sum carried" is one more add with carry.

// lo + hi * 2^64 (mod p) for hi < 2^32.
__device__ __forceinline__ uint64_t reduce_small(uint64_t lo, uint32_t hi) {
    uint32_t rl, rh;
    asm("{\n\t"
        ".reg .u32 z, t1l, t1h, c;\n\t"
        "mov.u32 z, 0;\n\t"
        "sub.cc.u32 t1l, z, %4;\n\t"   // t1 = hi * (2^32 - 1) = (hi << 32) - hi
        "subc.u32 t1h, %4, z;\n\t"
        "add.cc.u32 %0, %2, t1l;\n\t"  // r = lo + t1
        "addc.cc.u32 %1, %3, t1h;\n\t"
        "addc.u32 c, z, z;\n\t"
        "neg.s32 c, c;\n\t"
        "add.cc.u32 %0, %0, c;\n\t"    // + 2^32 - 1 if it carried
        "addc.u32 %1, %1, z;\n\t"
        "}"
        : "=&r"(rl), "=&r"(rh)
        : "r"((uint32_t)lo), "r"((uint32_t)(lo >> 32)), "r"(hi));
    return ((uint64_t)rh << 32) | rl;
}

// lo + hi * 2^64 (mod p) for any hi.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    uint32_t rl, rh;
    asm("{\n\t"
        ".reg .u32 z, t0l, t0h, b, t1l, t1h, c;\n\t"
        "mov.u32 z, 0;\n\t"
        "sub.cc.u32 t0l, %2, %5;\n\t"  // t0 = lo - hi_hi            (2^96 = -1)
        "subc.cc.u32 t0h, %3, z;\n\t"
        "subc.u32 b, z, z;\n\t"        // 0xFFFFFFFF if it borrowed
        "sub.cc.u32 t0l, t0l, b;\n\t"  // - (2^32 - 1) then: + 2^64 - (2^32 - 1) = + p
        "subc.u32 t0h, t0h, z;\n\t"
        "sub.cc.u32 t1l, z, %4;\n\t"   // t1 = hi_lo * (2^32 - 1)     (2^64 = 2^32 - 1)
        "subc.u32 t1h, %4, z;\n\t"
        "add.cc.u32 %0, t0l, t1l;\n\t" // r = t0 + t1
        "addc.cc.u32 %1, t0h, t1h;\n\t"
        "addc.u32 c, z, z;\n\t"
        "neg.s32 c, c;\n\t"
        "add.cc.u32 %0, %0, c;\n\t"    // + 2^32 - 1 if it carried
        "addc.u32 %1, %1, z;\n\t"
        "}"
        : "=&r"(rl), "=&r"(rh)
        : "r"((uint32_t)lo), "r"((uint32_t)(lo >> 32)), "r"((uint32_t)hi), "r"((uint32_t)(hi >> 32)));
    return ((uint64_t)rh << 32) | rl;
}

// a + c (mod p) for a canonical c.
__device__ __forceinline__ uint64_t add_rc(uint64_t a, uint64_t c) {
    uint64_t s = a + c;
    if (s < c) s += EPSILON;
    return s;
}

__device__ __forceinline__ uint64_t canonical(uint64_t x) { return x >= P ? x - P : x; }

// The product is left to the compiler (mul.lo.u64 and mul.hi.u64): spelling
// out the four IMAD.WIDE.U32 partial products by hand gave the same count
// of multiplies and cost eight more registers (measured on the H100).
__device__ __forceinline__ uint64_t mul_mod(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
    const uint64_t x2 = mul_mod(x, x);
    const uint64_t x3 = mul_mod(x2, x);
    const uint64_t x4 = mul_mod(x2, x2);
    return mul_mod(x3, x4);
}

// acc_hi * 2^32 + acc_lo (both < 2^41) as one word mod p.
__device__ __forceinline__ uint64_t join_halves(uint64_t acc_lo, uint64_t acc_hi) {
    const uint64_t l = acc_lo + (acc_hi << 32);
    const uint32_t h = (uint32_t)(acc_hi >> 32) + (l < acc_lo ? 1u : 0u);  // < 2^10
    return reduce_small(l, h);
}

// ---------------------------------------------------------------------------
// one state per thread

// s <- MDS s + c_post[r]
__device__ __forceinline__ void mds(uint64_t s[WIDTH], int r) {
    uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
        lo[k] = (uint32_t)s[k];
        hi[k] = (uint32_t)(s[k] >> 32);
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
        const uint64_t c = c_post[r * WIDTH + i];
        uint64_t acc_lo = (uint64_t)c_diag[i] * lo[i] + (uint32_t)c;
        uint64_t acc_hi = (uint64_t)c_diag[i] * hi[i] + (c >> 32);
#pragma unroll
        for (int t = 0; t < WIDTH; ++t) {
            acc_lo += (uint64_t)c_circ[t] * lo[(i + t) % WIDTH];
            acc_hi += (uint64_t)c_circ[t] * hi[(i + t) % WIDTH];
        }
        s[i] = join_halves(acc_lo, acc_hi);
    }
}

// round r without its constant add: the S-boxes, then the MDS with the
// folded constants
__device__ __forceinline__ void round_body(uint64_t s[WIDTH], int r) {
    if (r < 4 || r >= 26) {
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) s[k] = sbox7(s[k]);
    } else {
        s[0] = sbox7(s[0]);
    }
    mds(s, r);
}

// ZERO_CAP: lanes 8-11 of the input are zero (2-to-1 compression) and are
// not read.
template <bool ZERO_CAP = false>
__device__ __forceinline__ void add_first_constants(uint64_t s[WIDTH]) {
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) s[k] = (ZERO_CAP && k >= 8) ? c_pre[k] : add_rc(s[k], c_pre[k]);
}

template <bool ZERO_CAP = false>
__device__ __forceinline__ void permute(uint64_t s[WIDTH]) {
    add_first_constants<ZERO_CAP>(s);
#pragma unroll 1
    for (int r = 0; r < N_ROUNDS; ++r) round_body(s, r);
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) s[k] = canonical(s[k]);
}

// ---------------------------------------------------------------------------
// one state per 16-lane half of a warp

constexpr int SPLIT_LANES = 16;  // threads a state; the first 12 hold a word

// Per-thread constants of the split form: `post` points at a (30, 12) copy
// of c_post that threads index by their own lane (shared or global memory:
// constant memory serialises reads that differ across a warp).
//
// Threads 12-15 of a half-warp hold no word of their own. They mirror
// threads 0-3: same loads, same arithmetic, same stores of the same values.
// A kernel built on this form must keep every thread of the warp on one
// path from its loads to its stores (clamp an index past the end to the last
// state; do not predicate on the lane): if the stores hang on a condition
// that varies inside a warp, the compiler sinks the whole permutation under
// it, the warp reaches the shuffles diverged, and every shuffle takes its
// slow re-converging path.
struct SplitLane {
    int j;          // lane of the state this thread holds, 0..11
    int src[WIDTH]; // half-warp lane holding x_{(j + t) mod 12}
    uint32_t diag;  // c_diag[j]
    uint64_t pre;   // c_pre[j]
    uint64_t partial_mask;  // all ones on lane 0, which keeps its S-box in a partial round
};

__device__ __forceinline__ SplitLane split_lane(const uint64_t* pre, const uint32_t* diag) {
    SplitLane L;
    const int j = threadIdx.x & (SPLIT_LANES - 1);
    L.j = j < WIDTH ? j : j - WIDTH;
#pragma unroll
    for (int t = 0; t < WIDTH; ++t) L.src[t] = (L.j + t) % WIDTH;
    L.diag = diag[L.j];
    L.pre = pre[L.j];
    L.partial_mask = L.j == 0 ? ~0ull : 0ull;
    asm volatile("" : "+l"(L.partial_mask));  // hide its origin from the optimiser (see permute_split)
    return L;
}

// The permutation of the state whose word j this thread holds in x. All 32
// threads of the warp must call it together. `post` is a (30, 12) table.
__device__ __forceinline__ uint64_t permute_split(uint64_t x, const SplitLane& L, const uint64_t* post) {
    const int j = L.j;
    x = add_rc(x, L.pre);
#pragma unroll 1
    for (int r = 0; r < N_ROUNDS; ++r) {
        // Every lane computes the S-box, and a mask keeps it or not. A branch
        // (or a select the compiler can turn into one) on the lane makes it
        // split the whole round loop by lane; the warp then stays diverged
        // and every shuffle below takes its slow, re-converging path: 13
        // times the cycles, measured. So the lane's mask is opaque data.
        const uint64_t y = sbox7(x);
        x ^= (x ^ y) & ((r < 4 || r >= 26) ? ~0ull : L.partial_mask);
        const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
        const uint64_t c = post[r * WIDTH + j];
        // two accumulators a half keep the dependent chains short
        uint64_t lo0 = (uint64_t)c_circ[0] * lo + (uint32_t)c, lo1 = (uint64_t)L.diag * lo;
        uint64_t hi0 = (uint64_t)c_circ[0] * hi + (c >> 32), hi1 = (uint64_t)L.diag * hi;
#pragma unroll
        for (int t = 1; t < WIDTH; ++t) {
            const uint32_t vlo = __shfl_sync(0xFFFFFFFFu, lo, L.src[t], SPLIT_LANES);
            const uint32_t vhi = __shfl_sync(0xFFFFFFFFu, hi, L.src[t], SPLIT_LANES);
            if (t & 1) {
                lo1 += (uint64_t)c_circ[t] * vlo;
                hi1 += (uint64_t)c_circ[t] * vhi;
            } else {
                lo0 += (uint64_t)c_circ[t] * vlo;
                hi0 += (uint64_t)c_circ[t] * vhi;
            }
        }
        x = join_halves(lo0 + lo1, hi0 + hi1);
    }
    return canonical(x);
}

}  // namespace p2v
