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
//     (the carries counted as free flags)
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
// tools/probe_kernels.py computes each kernel's bound from W and the clock it reads.
// W keeps the textbook round structure (every partial round a full MDS), so
// a time read against it cannot pass 100 %.
//
// The thread form runs the partial rounds in Plonky2's sparse form instead
// (`partial_rounds`), and the trade is in the multiply pipe, which binds (see
// below), more than in the count: a sparse round is 404 SASS instructions, of
// them 98 IMAD.WIDE, on 23 products by full-width constants; a dense round was
// 490, of them ~266 IMAD.WIDE on twelve rows of coefficients below 2^6. A
// permutation went from 21,344 instructions (8,893 IMAD.WIDE) to 20,549
// (5,527), and on the H100 the Merkle walk, the grouped sponge and the scan at
// 16,384 states ran 16-20 % faster (kernels.sass_instruction_count;
// tools/probe_kernels.py, in turns with the dense form).
//
// How the thread form keeps near W (20,549 SASS instructions a permutation,
// 1.07 W):
// - Every multiply-add is a PTX pair mad.lo.cc / madc.hi on the same
//   operands, which ptxas emits as one IMAD.WIDE.U32 that adds a 64-bit word.
//   From C, or from a plain mad.wide.u32, ptxas emits each product alone and
//   sums them with IADD3 trees: an MDS row took ~48 instructions, now 24 and
//   the join. The carries are add.cc / addc chains, never compares and
//   selects.
// - The MDS coefficients are immediates (MDS_CIRC, MDS_DIAG): row 0 alone
//   has a diagonal term. A coefficient of 2 is added twice with carries:
//   after the rewrite the multiply pipe, which runs the IMAD.WIDE, binds,
//   and two adds on the ALU pipe finish sooner than one more IMAD.WIDE
//   (21,344 instructions in 3 % less time than 19,860 with the products).
//   For the same reason a carry k is added back as k (2^32 - 1) with adds,
//   not a multiply.
// - Words stay below 2^64 but not canonical between rounds; `canonical` runs
//   once at the end of `permute`. `mul_mod` and `join_halves` argue their
//   ranges where they are defined. `add_rc` needs one canonical operand (the
//   round constant): on a carry the wrapped sum is at most p - 2. So every
//   input word below 2^64, the non-canonical p and 2^64 - 1 among them,
//   gives the canonical result.
// - An MDS row sums 12 coefficients of sum 256 (+ 8 on lane 0's diagonal)
//   times words below 2^64, plus a folded constant. Each lane is split into
//   32-bit halves and each half is summed in a 64-bit word: the high halves'
//   sum is below 264 * 2^32 < 2^41, the low halves' sum starts from the
//   whole constant, which kernels.py checks leaves it the room `join_halves`
//   needs.
// - Round constants: `c_pre` is round 0's; `c_full[f]` is what full round
//   f's MDS rows start their sums from, the next round's constants (after
//   round 3, Plonky2's FAST_PARTIAL_FIRST_ROUND_CONSTANT). The sparse rounds
//   start row 0 from theirs and carry those of lanes 1-11 to the end
//   (`sparse_round` says how); round 29's MDS reads none. The split form's
//   table is its own (permutation.cu): there a partial round's dense MDS
//   commutes with the constants of lanes 1-11, which arrive, multiplied
//   through, before round 26. kernels.py computes every table from
//   golden/poseidon_constants.py and checks the ranges they assume.
// - In a 2-to-1 compression lanes 8-11 enter as zero: `permute<true, 4>`
//   starts them at the constant, and its last MDS computes rows 0-3 only,
//   the digest the Merkle walk keeps.
// - The rounds run in rolled loops (`permute` says how), one copy of each
//   body: the full round, the sparse round, an output of the initial matrix.
//   The code a warp walks stays small: the initial matrix unrolled took the
//   Merkle walk past its 72 registers (424 bytes of spill) and 14 % slower.
//
// Two forms of the permutation:
// - `permute`: one 12-lane state per thread, in registers (every lane index
//   is a compile-time constant after unrolling). The form for many states:
//   all the work, no traffic between threads.
// - `permute_split`: one state per 16-lane half of a warp, one word a thread
//   (lanes 12-15 mirror lanes 0-3), the 12 words carried to each MDS row by
//   __shfl_sync. A full round's S-boxes run in parallel; in a partial round
//   only lane 0's is kept. It keeps the dense partial rounds: in the sparse
//   form row 0 would wait on a 12-lane shuffle reduction every round, on the
//   chain this form exists to shorten. It spends ~4x the instructions a state
//   but cuts the serial chain a thread walks by about ten, which is what a
//   small batch (a transcript step of 1024 states) waits for. It keeps its
//   own product (`mul_mod_split`) and C rows: a thread there waits on its
//   own chain, so a short chain matters more than few instructions.
//
// The round constants are not written here: each translation unit owns a
// copy of the tables and fills it from its *_init entry point, which the
// Python loader calls.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace p2v {

constexpr int WIDTH = 12;
constexpr int N_ROUNDS = 30;
constexpr int HALF_FULL = 4;  // full rounds before the partial ones, and after
constexpr int N_PARTIAL = 22;
constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;  // 2^64 mod p

// Plonky2's MDS_MATRIX_CIRC and MDS_MATRIX_DIAG (hash/poseidon_goldilocks.rs;
// golden/poseidon_constants.py, which a CPU test holds these equal to). The
// split form reads the circulant from the constant bank (`c_circ`): its rows
// are C, and from C a product by an immediate power of two becomes 64-bit
// shifts and masks.
#define P2V_MDS_CIRC 17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20
#define P2V_MDS_DIAG 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
__device__ constexpr uint32_t MDS_CIRC[WIDTH] = {P2V_MDS_CIRC};
__device__ constexpr uint32_t MDS_DIAG[WIDTH] = {P2V_MDS_DIAG};
static __constant__ uint32_t c_circ[WIDTH] = {P2V_MDS_CIRC};

// The thread form's tables (kernels.sparse_round_tables computes them from
// golden/poseidon_constants.py; one array, in this order, SPARSE_TABLE_WORDS
// words):
// - c_full[f]: what full round f's MDS rows start their sums from (rounds 0-3,
//   then 26-28): the next round's constants, for round 3 Plonky2's
//   FAST_PARTIAL_FIRST_ROUND_CONSTANT;
// - c_init[c * 11 + j]: FAST_PARTIAL_ROUND_INITIAL_MATRIX[j][c], the weight of
//   lane j + 1 in lane c + 1 after the initial matrix;
// - c_w_hat, c_vs: FAST_PARTIAL_ROUND_W_HATS and _VS, 11 words a round;
// - c_row0[r]: what sparse round r's row 0 starts from (see sparse_round);
// - c_tail[j]: what lane j + 1 still owes after the last sparse round.
constexpr int SPARSE = WIDTH - 1;  // lanes 1-11
constexpr int N_FULL_MDS = 2 * HALF_FULL - 1;  // full rounds whose MDS starts from constants
constexpr int SPARSE_TABLE_WORDS = N_FULL_MDS * WIDTH + SPARSE * SPARSE + 2 * N_PARTIAL * SPARSE + N_PARTIAL + SPARSE;

static __constant__ uint64_t c_pre[WIDTH];
static __constant__ uint64_t c_full[N_FULL_MDS * WIDTH];
static __constant__ uint64_t c_init[SPARSE * SPARSE];
static __constant__ uint64_t c_w_hat[N_PARTIAL * SPARSE];
static __constant__ uint64_t c_vs[N_PARTIAL * SPARSE];
static __constant__ uint64_t c_row0[N_PARTIAL];
static __constant__ uint64_t c_tail[SPARSE];

static int g_sms = 132;  // read from the device by upload_constants

static cudaError_t upload_constants(const void* pre, const void* sparse) {
    cudaError_t e = cudaMemcpyToSymbol(c_pre, pre, sizeof(c_pre));
    size_t at = 0;
    auto next = [&](const void* symbol, size_t bytes) {
        if (e == cudaSuccess) e = cudaMemcpyToSymbol(symbol, (const char*)sparse + at, bytes);
        at += bytes;
    };
    next(c_full, sizeof(c_full));
    next(c_init, sizeof(c_init));
    next(c_w_hat, sizeof(c_w_hat));
    next(c_vs, sizeof(c_vs));
    next(c_row0, sizeof(c_row0));
    next(c_tail, sizeof(c_tail));
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
// canonical.

// acc + a * b: one IMAD.WIDE.U32 (the caller keeps the sum below 2^64).
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t acc) {
    uint32_t lo = (uint32_t)acc, hi = (uint32_t)(acc >> 32);
    asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\t"
        "madc.hi.u32 %1, %2, %3, %1;"
        : "+r"(lo), "+r"(hi)
        : "r"(a), "r"(b));
    return ((uint64_t)hi << 32) | lo;
}

// acc + a * c for an MDS coefficient c: c = 2 as two adds with carries (ALU
// pipe), any other as one IMAD.WIDE (multiply pipe).
__device__ __forceinline__ uint64_t mad_coef(uint32_t a, uint32_t c, uint64_t acc) {
    if (c != 2) return mad_wide(a, c, acc);
    uint32_t lo = (uint32_t)acc, hi = (uint32_t)(acc >> 32);
    asm("{\n\t"
        ".reg .u32 z;\n\t"
        "mov.u32 z, 0;\n\t"
        "add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, z;\n\t"
        "add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, z;\n\t"
        "}"
        : "+r"(lo), "+r"(hi)
        : "r"(a));
    return ((uint64_t)hi << 32) | lo;
}

// a + c (mod p) for a canonical c.
__device__ __forceinline__ uint64_t add_rc(uint64_t a, uint64_t c) {
    uint64_t s = a + c;
    if (s < c) s += EPSILON;
    return s;
}

__device__ __forceinline__ uint64_t canonical(uint64_t x) { return x >= P ? x - P : x; }

// a * b (mod p), one carry chain. The 128-bit product (r3, r2, r1, r0): a0 b0
// and a1 b1 side by side, the cross products added at 2^32. Then, with
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), r0 + r1 2^32 - r3 + r2 (2^32 - 1):
// - t = (r1, r0) - r3; on a borrow the wrapped t is at least 2^64 - 2^32 + 1
//   (r3 < 2^32), and taking 2^32 - 1 from it cannot wrap;
// - t + r2 (2^32 - 1) as one multiply-add, with a carry k out; on a carry
//   the wrapped sum is below r2 (2^32 - 1) <= 2^64 - 2^33 + 1, so adding
//   k (2^32 - 1) back (k 2^32 - k, with adds) cannot carry again.
__device__ __forceinline__ uint64_t mul_mod(uint64_t a, uint64_t b) {
    uint32_t rl, rh;
    asm("{\n\t"
        ".reg .u32 z, e, r0, r1, r2, r3, b, k;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.u32 e, 0xFFFFFFFF;\n\t"
        "mul.lo.u32 r0, %2, %4;\n\t"
        "mul.hi.u32 r1, %2, %4;\n\t"
        "mul.lo.u32 r2, %3, %5;\n\t"
        "mul.hi.u32 r3, %3, %5;\n\t"
        "mad.lo.cc.u32 r1, %2, %5, r1;\n\t"
        "madc.hi.cc.u32 r2, %2, %5, r2;\n\t"
        "addc.u32 r3, r3, z;\n\t"
        "mad.lo.cc.u32 r1, %3, %4, r1;\n\t"
        "madc.hi.cc.u32 r2, %3, %4, r2;\n\t"
        "addc.u32 r3, r3, z;\n\t"
        "sub.cc.u32 r0, r0, r3;\n\t"
        "subc.cc.u32 r1, r1, z;\n\t"
        "subc.u32 b, z, z;\n\t"  // 0xFFFFFFFF if it borrowed
        "sub.cc.u32 r0, r0, b;\n\t"
        "subc.u32 r1, r1, z;\n\t"
        "mad.lo.cc.u32 r0, r2, e, r0;\n\t"
        "madc.hi.cc.u32 r1, r2, e, r1;\n\t"
        "addc.u32 k, z, z;\n\t"
        "sub.cc.u32 %0, r0, k;\n\t"
        "subc.u32 %1, r1, z;\n\t"
        "add.u32 %1, %1, k;\n\t"
        "}"
        : "=r"(rl), "=r"(rh)
        : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b), "r"((uint32_t)(b >> 32)));
    return ((uint64_t)rh << 32) | rl;
}

// The split form's product, a * b (mod p): the compiler's 64 x 64 multiply
// and this reduction of (hi, lo), with the same ranges as `mul_mod`'s. It
// spends more instructions than `mul_mod`, but its pieces wait less on each
// other, and a split-form thread has nothing else to issue meanwhile: the
// transcript scan at 1024 states ran 1.6 times as long with `mul_mod`
// (measured on the H100).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    uint32_t rl, rh;
    asm("{\n\t"
        ".reg .u32 z, t0l, t0h, b, t1l, t1h, c;\n\t"
        "mov.u32 z, 0;\n\t"
        "sub.cc.u32 t0l, %2, %5;\n\t"   // t0 = lo - hi_hi            (2^96 = -1)
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

__device__ __forceinline__ uint64_t mul_mod_split(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
}

// x^7 = x^3 x^4 from x^2 = x x, x^3 = x^2 x, x^4 = x^2 x^2; SPLIT takes the
// split form's product.
template <bool SPLIT = false>
__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
    auto mul = [](uint64_t a, uint64_t b) { return SPLIT ? mul_mod_split(a, b) : mul_mod(a, b); };
    const uint64_t x2 = mul(x, x);
    const uint64_t x3 = mul(x2, x);
    const uint64_t x4 = mul(x2, x2);
    return mul(x3, x4);
}

// acc_lo + acc_hi 2^32 (mod p), for acc_lo + (acc_hi >> 32) (2^32 - 1) < 2^64.
// With acc_hi = h 2^32 + m and 2^64 = 2^32 - 1: u = acc_lo + h (2^32 - 1) as
// one multiply-add, which the bound keeps from wrapping; m joins u's high
// half with a carry k out, and k (2^32 - 1) is added back: on a carry the
// high half wrapped below m, so it cannot carry again.
__device__ __forceinline__ uint64_t join_halves(uint64_t acc_lo, uint64_t acc_hi) {
    uint32_t rl, rh;
    asm("{\n\t"
        ".reg .u32 z, e, k;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.u32 e, 0xFFFFFFFF;\n\t"
        "mad.lo.cc.u32 %0, %5, e, %2;\n\t"
        "madc.hi.u32 %1, %5, e, %3;\n\t"
        "add.cc.u32 %1, %1, %4;\n\t"
        "addc.u32 k, z, z;\n\t"
        "sub.cc.u32 %0, %0, k;\n\t"
        "subc.u32 %1, %1, z;\n\t"
        "add.u32 %1, %1, k;\n\t"
        "}"
        : "=&r"(rl), "=&r"(rh)
        : "r"((uint32_t)acc_lo), "r"((uint32_t)(acc_lo >> 32)), "r"((uint32_t)acc_hi), "r"((uint32_t)(acc_hi >> 32)));
    return ((uint64_t)rh << 32) | rl;
}

// ---------------------------------------------------------------------------
// one state per thread

// Rows 0 .. ROWS - 1 of s <- MDS s + c. The first N_CONST rows start their
// low sum from their whole constant c[i], the others from zero. A row is two
// chains of multiply-adds, over the lanes' low halves and over their high
// halves, then the join.
template <int ROWS, int N_CONST>
__device__ __forceinline__ void mds(uint64_t s[WIDTH], const uint64_t* c) {
    uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
        lo[k] = (uint32_t)s[k];
        hi[k] = (uint32_t)(s[k] >> 32);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        uint64_t acc_lo = i < N_CONST ? c[i] : 0, acc_hi = 0;
        if (MDS_DIAG[i] != 0) {
            acc_lo = mad_coef(lo[i], MDS_DIAG[i], acc_lo);
            acc_hi = mad_coef(hi[i], MDS_DIAG[i], acc_hi);
        }
#pragma unroll
        for (int t = 0; t < WIDTH; ++t) {
            acc_lo = mad_coef(lo[(i + t) % WIDTH], MDS_CIRC[t], acc_lo);
            acc_hi = mad_coef(hi[(i + t) % WIDTH], MDS_CIRC[t], acc_hi);
        }
        s[i] = join_halves(acc_lo, acc_hi);
    }
}

__device__ __forceinline__ void full_sbox(uint64_t s[WIDTH]) {
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) s[k] = sbox7(s[k]);
}

// ZERO_CAP: lanes 8-11 of the input are zero (2-to-1 compression) and are
// not read.
template <bool ZERO_CAP = false>
__device__ __forceinline__ void add_first_constants(uint64_t s[WIDTH]) {
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) s[k] = (ZERO_CAP && k >= 8) ? c_pre[k] : add_rc(s[k], c_pre[k]);
}

// ---------------------------------------------------------------------------
// the partial rounds in Plonky2's sparse form (poseidon.rs: partial_rounds)

// A dot product of full-width words, summed exactly and reduced once. The sum
// is kept in 32-bit words: A = (a4, a3, a2, a1, a0) takes the start and each
// term's x_lo w_lo + x_hi w_hi 2^64, B = (b2, b1, b0) the cross products
// x_lo w_hi + x_hi w_lo at weight 2^32. Each product is a multiply-add whose
// carry runs into the next word, and a4 and b2 count the carries out of the
// top, at most one a product: for words below 2^64, 12 terms at most and a
// start below 2^64 + 2^37, A < 13 2^128 and B < 24 2^64, so neither wraps.
struct Dot {
    uint32_t a0, a1, a2, a3, a4, b0, b1, b2;
};

// start + m y for a 32-bit coefficient m: A = start + m y_lo, B = m y_hi.
__device__ __forceinline__ Dot dot_start(uint64_t start, uint64_t y, uint32_t m) {
    Dot d;
    asm("{\n\t"
        ".reg .u32 z;\n\t"
        "mov.u32 z, 0;\n\t"
        "mad.lo.cc.u32 %0, %8, %10, %11;\n\t"
        "madc.hi.cc.u32 %1, %8, %10, %12;\n\t"
        "addc.u32 %2, z, z;\n\t"
        "mul.lo.u32 %5, %9, %10;\n\t"
        "mul.hi.u32 %6, %9, %10;\n\t"
        "mov.u32 %3, z;\n\t"
        "mov.u32 %4, z;\n\t"
        "mov.u32 %7, z;\n\t"
        "}"
        : "=&r"(d.a0), "=&r"(d.a1), "=&r"(d.a2), "=&r"(d.a3), "=&r"(d.a4), "=&r"(d.b0), "=&r"(d.b1), "=&r"(d.b2)
        : "r"((uint32_t)y), "r"((uint32_t)(y >> 32)), "r"(m), "r"((uint32_t)start), "r"((uint32_t)(start >> 32)));
    return d;
}

// d += x w: four multiply-adds, x_lo w_lo and x_hi w_hi as one 128-bit add
// into A, the cross products into B.
__device__ __forceinline__ void dot_term(Dot& d, uint64_t x, uint64_t w) {
    asm("{\n\t"
        ".reg .u32 z;\n\t"
        "mov.u32 z, 0;\n\t"
        "mad.lo.cc.u32 %0, %8, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "addc.u32 %4, %4, z;\n\t"
        "mad.lo.cc.u32 %5, %8, %11, %5;\n\t"
        "madc.hi.cc.u32 %6, %8, %11, %6;\n\t"
        "addc.u32 %7, %7, z;\n\t"
        "mad.lo.cc.u32 %5, %9, %10, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %10, %6;\n\t"
        "addc.u32 %7, %7, z;\n\t"
        "}"
        : "+r"(d.a0), "+r"(d.a1), "+r"(d.a2), "+r"(d.a3), "+r"(d.a4), "+r"(d.b0), "+r"(d.b1), "+r"(d.b2)
        : "r"((uint32_t)x), "r"((uint32_t)(x >> 32)), "r"((uint32_t)w), "r"((uint32_t)(w >> 32)));
}

// The sum A + B 2^32 = (t4, t3, t2, t1, a0) in 32-bit words (mod p), with
// 2^64 = 2^32 - 1, 2^96 = -1 and 2^128 = -2^32: (t1, a0) - (t4, t3) + t2 (2^32 - 1).
// - (t4, t3) < 13 2^32 (the sum is below 13 2^128): on a borrow the wrapped
//   difference is at least 2^64 - 13 2^32, and taking 2^32 - 1 from it
//   cannot wrap (it adds p);
// - t2 (2^32 - 1) as one multiply-add with a carry k out; on a carry the
//   wrapped sum is below t2 (2^32 - 1) <= 2^64 - 2^33 + 1, so adding k (2^32 - 1)
//   back cannot carry again. As `mul_mod`'s tail.
__device__ __forceinline__ uint64_t dot_reduce(const Dot& d) {
    uint32_t rl, rh;
    asm("{\n\t"
        ".reg .u32 z, e, t1, t2, t3, t4, b, k;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.u32 e, 0xFFFFFFFF;\n\t"
        "add.cc.u32 t1, %3, %7;\n\t"
        "addc.cc.u32 t2, %4, %8;\n\t"
        "addc.cc.u32 t3, %5, %9;\n\t"
        "addc.u32 t4, %6, z;\n\t"
        "sub.cc.u32 %0, %2, t3;\n\t"
        "subc.cc.u32 %1, t1, t4;\n\t"
        "subc.u32 b, z, z;\n\t"  // 0xFFFFFFFF if it borrowed
        "sub.cc.u32 %0, %0, b;\n\t"
        "subc.u32 %1, %1, z;\n\t"
        "mad.lo.cc.u32 %0, t2, e, %0;\n\t"
        "madc.hi.cc.u32 %1, t2, e, %1;\n\t"
        "addc.u32 k, z, z;\n\t"
        "sub.cc.u32 %0, %0, k;\n\t"
        "subc.u32 %1, %1, z;\n\t"
        "add.u32 %1, %1, k;\n\t"
        "}"
        : "=&r"(rl), "=&r"(rh)
        : "r"(d.a0), "r"(d.a1), "r"(d.a2), "r"(d.a3), "r"(d.a4), "r"(d.b0), "r"(d.b1), "r"(d.b2));
    return ((uint64_t)rh << 32) | rl;
}

// a + y v (mod p): `mul_mod` with a as the addend of its first product. The
// 128-bit y v + a <= (2^64 - 1) (v + 1) stays below 2^128 for v < 2^64, so the
// top word does not wrap; the reduction is `mul_mod`'s, with its ranges.
__device__ __forceinline__ uint64_t mul_add_mod(uint64_t y, uint64_t v, uint64_t a) {
    uint32_t rl, rh;
    asm("{\n\t"
        ".reg .u32 z, e, r0, r1, r2, r3, b, k;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.u32 e, 0xFFFFFFFF;\n\t"
        "mad.lo.cc.u32 r0, %2, %4, %6;\n\t"
        "madc.hi.cc.u32 r1, %2, %4, %7;\n\t"
        "madc.lo.cc.u32 r2, %3, %5, z;\n\t"
        "madc.hi.u32 r3, %3, %5, z;\n\t"
        "mad.lo.cc.u32 r1, %2, %5, r1;\n\t"
        "madc.hi.cc.u32 r2, %2, %5, r2;\n\t"
        "addc.u32 r3, r3, z;\n\t"
        "mad.lo.cc.u32 r1, %3, %4, r1;\n\t"
        "madc.hi.cc.u32 r2, %3, %4, r2;\n\t"
        "addc.u32 r3, r3, z;\n\t"
        "sub.cc.u32 r0, r0, r3;\n\t"
        "subc.cc.u32 r1, r1, z;\n\t"
        "subc.u32 b, z, z;\n\t"  // 0xFFFFFFFF if it borrowed
        "sub.cc.u32 r0, r0, b;\n\t"
        "subc.u32 r1, r1, z;\n\t"
        "mad.lo.cc.u32 r0, r2, e, r0;\n\t"
        "madc.hi.cc.u32 r1, r2, e, r1;\n\t"
        "addc.u32 k, z, z;\n\t"
        "sub.cc.u32 %0, r0, k;\n\t"
        "subc.u32 %1, r1, z;\n\t"
        "add.u32 %1, %1, k;\n\t"
        "}"
        : "=r"(rl), "=r"(rh)
        : "r"((uint32_t)y), "r"((uint32_t)(y >> 32)), "r"((uint32_t)v), "r"((uint32_t)(v >> 32)),
          "r"((uint32_t)a), "r"((uint32_t)(a >> 32)));
    return ((uint64_t)rh << 32) | rl;
}

// Output c of the initial matrix on lanes 1-11 (which it reads, and does not
// write): out shifts down one place and out[10] takes the output, so after
// c = 0 .. 10 out[c] holds output c. One copy of the body in a rolled loop.
__device__ __forceinline__ void initial_matrix_step(const uint64_t s[WIDTH], uint64_t out[SPARSE], int c) {
    Dot d = {};
#pragma unroll
    for (int j = 0; j < SPARSE; ++j) dot_term(d, s[j + 1], c_init[c * SPARSE + j]);
#pragma unroll
    for (int k = 0; k + 1 < SPARSE; ++k) out[k] = out[k + 1];
    out[SPARSE - 1] = dot_reduce(d);
}

// Sparse round r (0-21): lane 0's S-box, then
//   lane 0 <- 25 y + sum_j W_HATS[r][j] s[j + 1] + c_row0[r],
//   lane j + 1 <- s[j + 1] + y VS[r][j]     (y: lane 0 after its S-box).
// Plonky2 adds FAST_PARTIAL_ROUND_CONSTANTS[r] to y after the S-box. Here its
// share of row 0 (25 c) starts row 0's sum, and its share of lanes 1-11
// (c VS[r][j]) is carried: lanes 1-11 run behind their true values by the
// carried words D_j, whose share of row 0 (sum_j W_HATS[r][j] D_j) c_row0[r]
// holds too, as row 0 of the last round holds round 26's constant of lane 0.
// c_tail pays D_j and round 26's constants of lanes 1-11 after the loop.
__device__ __forceinline__ void sparse_round(uint64_t s[WIDTH], int r) {
    const uint64_t y = sbox7(s[0]);
    Dot d = dot_start(c_row0[r], y, MDS_CIRC[0] + MDS_DIAG[0]);
#pragma unroll
    for (int j = 0; j < SPARSE; ++j) dot_term(d, s[j + 1], c_w_hat[r * SPARSE + j]);
#pragma unroll
    for (int j = 0; j < SPARSE; ++j) s[j + 1] = mul_add_mod(y, c_vs[r * SPARSE + j], s[j + 1]);
    s[0] = dot_reduce(d);
}

__device__ __forceinline__ void add_tail(uint64_t s[WIDTH]) {
#pragma unroll
    for (int j = 0; j < SPARSE; ++j) s[j + 1] = add_rc(s[j + 1], c_tail[j]);
}

// Rounds 4-25 (Plonky2's partial rounds), entered after round 3's MDS with
// FAST_PARTIAL_FIRST_ROUND_CONSTANT added (c_full[3]), left with round 26's
// constants added to every lane.
__device__ __forceinline__ void partial_rounds(uint64_t s[WIDTH]) {
    uint64_t out[SPARSE] = {};
#pragma unroll 1
    for (int c = 0; c < SPARSE; ++c) initial_matrix_step(s, out, c);
#pragma unroll
    for (int k = 0; k < SPARSE; ++k) s[k + 1] = out[k];
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) sparse_round(s, r);
    add_tail(s);
}

// The permutation. KEEP: the lanes the caller reads afterwards (4 for a
// 2-to-1 compression); the last round's MDS computes only those rows, and
// only they are made canonical.
//
// 4 full rounds, 22 partial, 4 full, in two rolled loops that hold one copy
// of each body. Step f of the outer loop runs full round f (f = 0-3) or
// 22 + f (f = 5-8), its MDS starting from c_full, and at f = 4 the partial
// rounds in their sparse form. Round 29's MDS has no constants. Three loops
// in a row would hold a second copy of the full round; the Merkle walk ran
// 20 % longer so (measured on the H100), the code a warp walks being larger
// than its instruction cache keeps.
template <bool ZERO_CAP = false, int KEEP = WIDTH>
__device__ __forceinline__ void permute(uint64_t s[WIDTH]) {
    add_first_constants<ZERO_CAP>(s);
#pragma unroll 1
    for (int f = 0;; ++f) {
        if (f == HALF_FULL) {
            partial_rounds(s);
            continue;
        }
        full_sbox(s);
        if (f == 2 * HALF_FULL) break;
        mds<WIDTH, WIDTH>(s, c_full + (f < HALF_FULL ? f : f - 1) * WIDTH);
    }
    mds<KEEP, 0>(s, nullptr);
#pragma unroll
    for (int k = 0; k < KEEP; ++k) s[k] = canonical(s[k]);
}

// ---------------------------------------------------------------------------
// one state per 16-lane half of a warp

constexpr int SPLIT_LANES = 16;  // threads a state; the first 12 hold a word

// Per-thread constants of the split form: `post` points at a (30, 12) copy
// of its table (kernels.folded_round_constants) that threads index by their
// own lane (shared or global memory: constant memory serialises reads that
// differ across a warp).
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
    uint32_t diag;  // MDS_DIAG[j]
    uint64_t pre;   // c_pre[j]
    uint64_t partial_mask;  // all ones on lane 0, which keeps its S-box in a partial round
};

__device__ __forceinline__ SplitLane split_lane(const uint64_t* pre) {
    SplitLane L;
    const int j = threadIdx.x & (SPLIT_LANES - 1);
    L.j = j < WIDTH ? j : j - WIDTH;
#pragma unroll
    for (int t = 0; t < WIDTH; ++t) L.src[t] = (L.j + t) % WIDTH;
    L.diag = 0;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) L.diag = L.j == k ? MDS_DIAG[k] : L.diag;
    asm volatile("" : "+r"(L.diag));  // opaque, as the mask below
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
        const uint64_t y = sbox7<true>(x);
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
