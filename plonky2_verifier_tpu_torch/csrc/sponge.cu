// Row sponge: rows (n, width) -> digests (n, 4), u64 words.
//
// Replaces plonky2_verifier_tpu/ops/pallas_hash.py  sponge_rows
// (_sponge_kernel): the rate-8 overwrite sponge that hashes the public
// inputs, the four oracle leaf rows and the FRI coset leaves.
//
// Bound: integer ALU work, ceil(width / 8) permutations a row (see
// poseidon.cuh); each row is read once. Design: one thread per row,
// grid-stride; the 12-lane state stays in registers across the chunk loop.
// A partial last chunk overwrites only its first width % 8 lanes; width 0
// leaves the zero state, so the digest is zeros. The TPU kernel's 8-row
// chunk padding was a Mosaic alignment rule and is not carried over.
#include "poseidon.cuh"

using namespace p2v;

namespace {

constexpr int THREADS = 64;

unsigned grid_for(int64_t n) {
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    const int64_t cap = (int64_t)g_sms * 64;  // grid-stride beyond this
    return (unsigned)(blocks < cap ? blocks : cap);
}

__global__ void __launch_bounds__(THREADS)
sponge_kernel(const uint64_t* __restrict__ rows, uint64_t* __restrict__ out, int64_t n, int width) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
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
#pragma unroll
        for (int k = 0; k < 4; ++k) out[i * 4 + k] = s[k];
    }
}

}  // namespace

extern "C" int p2v_sponge_init(const void* pre, const void* post, const void* circ, const void* diag) {
    return (int)upload_constants(pre, post, circ, diag);
}

extern "C" int p2v_sponge_rows(const void* rows, void* out, int64_t n, int width, void* stream) {
    if (n > 0) {
        sponge_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint64_t*)rows, (uint64_t*)out, n, width);
    }
    return (int)cudaGetLastError();
}
