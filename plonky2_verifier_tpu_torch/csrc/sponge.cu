// Row sponge: rows (n, width) -> digests (n, 4), u64 words, for one matrix
// of rows or for a group of matrices of different widths in one launch.
//
// Replaces plonky2_verifier_tpu/ops/pallas_hash.py  sponge_rows
// (_sponge_kernel): the rate-8 overwrite sponge that hashes the public
// inputs, the four oracle leaf rows and the FRI coset leaves. A partial last
// chunk overwrites only its first width % 8 lanes; width 0 leaves the zero
// state, so the digest is zeros. The TPU kernel's 8-row chunk padding was a
// Mosaic alignment rule and is not carried over.
//
// Bound: integer ALU work, ceil(width / 8) permutations a row (W in
// poseidon.cuh). The bytes are nothing beside it: a thread reads 64
// consecutive bytes a chunk, two full sectors, and a (28672, 135) matrix is
// 0.009 ms of memory traffic against 0.56 ms of integer work.
//
// What the H100 showed (a probe of the kernel timed every point below, on
// the six matrices of one verifier call, 172,032 rows of widths 135, 83, 32,
// 32, 20 and 16): a warp scheduler retires this round body fastest with
// exactly two warps on it. One warp alone leaves the S-box chain's latency
// in the open (104k cycles a permutation; two warps on a scheduler take
// about 80k each). From three warps on, when the warps are not in step, the
// time a permutation grows again: 2.80 ms with 8 one-warp blocks an SM,
// 3.10 with 10, 3.12 with 16, 4.58 with 28; and 3.18 with 6, 3.77 with 4.
// So what held the first version under its bound was not too few warps. One
// matrix of 28,672 rows is 896 warps for 528 schedulers: most hold two, the
// rest one, and every launch ends with a ragged tail; six launches pay that
// six times (3.31 ms).
//
// Design:
// - One launch takes up to MAX_SEGMENTS matrices (`Segments`, passed by
//   value: the kernel reads it from the constant bank and allocates
//   nothing). None of the verifier's row hashes waits for another, so the
//   six become one launch.
// - Blocks are one warp, BLOCKS_PER_SM = 8 of them an SM (two a scheduler)
//   and no more, however many rows there are. A warp never straddles two
//   segments (each is rounded up to whole warps), so all active threads of a
//   warp walk the same number of chunks.
// - Each block draws its next warp of rows from a counter (one atomicAdd a
//   warp of rows). The caller orders the segments longest rows first, so the
//   draw is longest-first list scheduling: the warps that walk 17
//   permutations start first, the short rows fill the gaps, and the blocks
//   end within one short row of each other. The same 8 blocks an SM walking
//   a fixed stride take 3.09 ms, one block a warp of rows (the hardware
//   hands them out in order) 2.91.
// - The launch bound asks for 16 blocks an SM: up to 128 registers (the round
//   body takes 94), no spill. With the round body before csrc/poseidon.cuh's
//   present one, the Merkle walk's bound of 28 (72 registers, 8 bytes of
//   spill in a loop that also keeps the row pointer and the chunk count) cost
//   4 % here (2.93 ms), and a bound of 1 (144 registers) 3 % (2.89).
// - The loop is the plain one: load 8 words, `permute`, again. Two steps
//   were built, measured and taken out again: the next chunk in flight
//   during the permutation (cp.async into shared memory: 2.7992 against
//   2.7994 ms, the other warp on the scheduler already hides the load) and a
//   sponge form of the permutation (no canonicalisation between chunks,
//   constants as the start of lanes 8-11 in the first chunk, four MDS rows in
//   the last round: 2.837 against 2.799 ms, 1.3 % slower; it saves under 1 %
//   of the instructions and its two run-time branches cost more).
#include "poseidon.cuh"

using namespace p2v;

namespace {

constexpr int THREADS = 32;
constexpr int LAUNCH_BOUND_BLOCKS = 16;  // up to 128 registers a thread, no spill
constexpr int BLOCKS_PER_SM = 8;         // two warps a scheduler
constexpr int MAX_SEGMENTS = 16;
constexpr int NO_WARP = 0x7FFFFFFF;

// Segment k holds n[k] rows of width[k] words at rows[k]; its digests go to
// out rows out_row[k] ... out_row[k] + n[k]. first_warp[k] is the number of
// warps of rows in the segments before it (NO_WARP for an unused slot).
struct Segments {
    const uint64_t* rows[MAX_SEGMENTS];
    int64_t n[MAX_SEGMENTS];
    int64_t out_row[MAX_SEGMENTS];
    int first_warp[MAX_SEGMENTS];
    int width[MAX_SEGMENTS];
};

// The next warp of rows for this block: drawn from `counter` where there is
// one (lane 0 draws, all 32 lanes take its number), else `strided`. Every
// launch passes a counter; the strided branch stays because taking it out
// changed the kernel's code (88 registers for 92) and it ran no faster.
__device__ __forceinline__ int next_warp(int* counter, int strided) {
    if (counter == nullptr) return strided;
    int v = 0;
    if (threadIdx.x == 0) v = atomicAdd(counter, 1);
    return __shfl_sync(0xFFFFFFFFu, v, 0);
}

__device__ __forceinline__ void sponge_body(const Segments& seg, uint64_t* __restrict__ out, int total_warps,
                                            int* __restrict__ counter) {
    const int lane = threadIdx.x;
    for (int v = next_warp(counter, blockIdx.x); v < total_warps; v = next_warp(counter, v + gridDim.x)) {
        // the segment of warp v: the last one that starts at or before it
        // (constant indices only, so the table stays in the constant bank)
        const uint64_t* rows = seg.rows[0];
        int64_t n = seg.n[0], out_row = seg.out_row[0];
        int first = 0, width = seg.width[0];
#pragma unroll
        for (int k = 1; k < MAX_SEGMENTS; ++k) {
            if (v >= seg.first_warp[k]) {
                rows = seg.rows[k];
                n = seg.n[k];
                out_row = seg.out_row[k];
                first = seg.first_warp[k];
                width = seg.width[k];
            }
        }
        const int64_t i = (int64_t)(v - first) * THREADS + lane;
        if (i >= n) continue;  // meets the other lanes again at next_warp's shuffle
        const uint64_t* row = rows + i * width;
        uint64_t s[WIDTH];
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) s[k] = 0;
        for (int c = 0; c < width; c += 8) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (c + j < width) s[j] = row[c + j];
            permute(s);
        }
        uint64_t* o = out + (out_row + i) * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = s[k];
    }
}

__global__ void __launch_bounds__(THREADS, LAUNCH_BOUND_BLOCKS)
sponge_kernel(const __grid_constant__ Segments seg, uint64_t* __restrict__ out, int total_warps, int* counter) {
    sponge_body(seg, out, total_warps, counter);
}

// Fill `seg` from the host arrays; returns the warps of rows in all, or -1
// if there are too many segments or rows.
int make_segments(Segments& seg, const void* const* rows, const int64_t* n, const int* width,
                  const int64_t* out_row, int count) {
    if (count < 0 || count > MAX_SEGMENTS) return -1;
    int64_t warps = 0;
    for (int k = 0; k < MAX_SEGMENTS; ++k) {
        const bool used = k < count;
        seg.rows[k] = used ? (const uint64_t*)rows[k] : nullptr;
        seg.n[k] = used ? n[k] : 0;
        seg.out_row[k] = used ? out_row[k] : 0;
        seg.width[k] = used ? width[k] : 0;
        seg.first_warp[k] = used ? (int)warps : NO_WARP;
        if (used) {
            if (n[k] < 0 || width[k] < 0) return -1;
            warps += (n[k] + THREADS - 1) / THREADS;
            if (warps >= NO_WARP) return -1;
        }
    }
    return (int)warps;
}

}  // namespace

// pre: round 0's constants; sparse: the thread form's tables (poseidon.cuh).
extern "C" int p2v_sponge_init(const void* pre, const void* sparse) {
    return (int)upload_constants(pre, sparse);
}

// The most segments one grouped launch takes.
extern "C" int p2v_sponge_max_segments() { return MAX_SEGMENTS; }

// `count` matrices in one launch: rows[k] points at n[k] rows of width[k]
// words, whose digests are written to out rows out_row[k] onwards. The four
// arrays are host arrays; the caller orders the segments longest rows first.
// `counter` is one device int of scratch, zeroed here on the stream.
extern "C" int p2v_sponge_rows_grouped(const void* const* rows, const int64_t* n, const int* width,
                                       const int64_t* out_row, int count, void* out, void* counter, void* stream) {
    Segments seg;
    const int warps = make_segments(seg, rows, n, width, out_row, count);
    if (warps < 0 || counter == nullptr) return (int)cudaErrorInvalidValue;
    if (warps > 0) {
        const cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
        const int cap = BLOCKS_PER_SM * g_sms;
        sponge_kernel<<<cap < warps ? cap : warps, THREADS, 0, (cudaStream_t)stream>>>(
            seg, (uint64_t*)out, warps, (int*)counter);
    }
    return (int)cudaGetLastError();
}

extern "C" int p2v_sponge_rows(const void* rows, void* out, int64_t n, int width, void* counter, void* stream) {
    const int64_t out_row = 0;
    return p2v_sponge_rows_grouped(&rows, &n, &width, &out_row, 1, out, counter, stream);
}
