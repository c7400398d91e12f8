// Merkle path walk: digest (n, 4), index (n,), sibs (n, L, 4) -> root (n, 4).
//
// Replaces plonky2_verifier_tpu/ops/pallas_hash.py  merkle_fold
// (_merkle_kernel): the walk behind every FRI Merkle opening (the four
// initial oracles at L = 11 and each fold step's coset tree on the standard
// shape). The cap compare stays in PyTorch.
//
// Bound: integer ALU work, L permutations a path (W in poseidon.cuh); the
// siblings are read once (32 L + 40 bytes a path, far below the ALU time).
// Design: one thread per path. Index bit l says whether the current digest
// is the right child at level l; the state [left, right, 0^4] is built in
// registers and permuted (`permute<true, 4>`: the zero lanes start at their
// round constant, and the last round computes lanes 0-3 alone), and lanes
// 0-3 carry to the next level. All the time is in
// the shared round body, so that is where the design works (lazy reduction,
// folded constants: poseidon.cuh). Blocks are one warp, and the grid is cut
// so that every thread walks the same number of paths (`balanced_grid`): at
// 114,688 paths a grid of one path a thread is one wave of resident blocks
// and a sliver, and the sliver's walk would run with most SMs idle. The TPU
// kernel's 4 -> 8 sibling padding was a Mosaic alignment rule and is not
// carried over.
#include "poseidon.cuh"

using namespace p2v;

namespace {

constexpr int THREADS = 32;
// 28 warps an SM hold the compiler to 72 registers (it takes all 72, no spill), and
// 132 x 28 blocks take the standard shape's 3,584 in one wave. Left free it
// takes 80-130 registers, the wave shrinks, and the L = 11 walk is 15-40 %
// slower (measured on the H100).
constexpr int MIN_BLOCKS = 28;
int g_resident = 1;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
merkle_kernel(const uint64_t* __restrict__ digest, const int64_t* __restrict__ index,
              const uint64_t* __restrict__ sibs, uint64_t* __restrict__ out, int64_t n, int path_len) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        uint64_t cur[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) cur[k] = digest[i * 4 + k];
        const uint64_t idx = (uint64_t)index[i];
        const uint64_t* sib = sibs + i * (int64_t)path_len * 4;
        for (int l = 0; l < path_len; ++l) {
            const bool right = (idx >> l) & 1;
            uint64_t s[WIDTH];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint64_t sb = sib[l * 4 + k];
                s[k] = right ? sb : cur[k];
                s[4 + k] = right ? cur[k] : sb;
                s[8 + k] = 0;
            }
            permute<true, 4>(s);
#pragma unroll
            for (int k = 0; k < 4; ++k) cur[k] = s[k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) out[i * 4 + k] = cur[k];
    }
}

}  // namespace

// pre: round 0's constants; sparse: the thread form's tables (poseidon.cuh).
extern "C" int p2v_merkle_init(const void* pre, const void* sparse) {
    cudaError_t e = upload_constants(pre, sparse);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_resident, merkle_kernel, THREADS, 0);
    return (int)e;
}

extern "C" int p2v_merkle_fold(const void* digest, const void* index, const void* sibs, void* out,
                               int64_t n, int path_len, void* stream) {
    if (n > 0) {
        merkle_kernel<<<balanced_grid(n, THREADS, g_resident), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint64_t*)digest, (const int64_t*)index, (const uint64_t*)sibs, (uint64_t*)out, n,
            path_len);
    }
    return (int)cudaGetLastError();
}
