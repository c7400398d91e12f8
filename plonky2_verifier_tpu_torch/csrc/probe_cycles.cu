// Cycle counts of the Poseidon round body's pieces, for development: one
// block of one warp (then four) runs 20 dependent repetitions of a modular
// multiply, an S-box, a shuffle, the half-warp permutation and the
// one-thread permutation, with clock64() around each. A stand-alone
// program (tools/probe_kernels.py builds and runs it); the constants are
// placeholders, since only the time is read.
#include "poseidon.cuh"

#include <cstdio>

using namespace p2v;

__device__ uint64_t g_post[N_ROUNDS * WIDTH];
__device__ uint64_t g_pre[WIDTH];

__global__ void probe(uint64_t* out, long long* cycles, int reps) {
    __shared__ uint64_t post[N_ROUNDS * WIDTH];
    for (int k = threadIdx.x; k < N_ROUNDS * WIDTH; k += blockDim.x) post[k] = g_post[k];
    __syncthreads();
    const SplitLane L = split_lane(g_pre);
    uint64_t x = threadIdx.x * 0x9E3779B97F4A7C15ull + 1;
    const long long t0 = clock64();
    for (int i = 0; i < reps; ++i) x = mul_mod(x, x);
    const long long t1 = clock64();
    for (int i = 0; i < reps; ++i) x = sbox7(x);
    const long long t2 = clock64();
    uint32_t lo = (uint32_t)x;
    for (int i = 0; i < reps; ++i) lo = __shfl_sync(0xFFFFFFFFu, lo, L.src[1], SPLIT_LANES) + 1;
    const long long t3 = clock64();
    x += lo;
    for (int i = 0; i < reps; ++i) x = permute_split(x, L, post);
    const long long t4 = clock64();
    uint64_t s[WIDTH];
    for (int k = 0; k < WIDTH; ++k) s[k] = x + k;
    for (int i = 0; i < reps; ++i) permute(s);
    const long long t5 = clock64();
    out[threadIdx.x] = x + s[0] + s[5];
    if (threadIdx.x == 0) {
        cycles[0] = t1 - t0;
        cycles[1] = t2 - t1;
        cycles[2] = t3 - t2;
        cycles[3] = t4 - t3;
        cycles[4] = t5 - t4;
    }
}

int main() {
    uint64_t* out;
    long long* cycles;
    if (cudaMalloc(&out, 8 * 128) != cudaSuccess || cudaMallocManaged(&cycles, 8 * 5) != cudaSuccess) return 1;
    uint64_t pre[WIDTH], post[N_ROUNDS * WIDTH], sparse[SPARSE_TABLE_WORDS];
    for (int i = 0; i < WIDTH; ++i) pre[i] = i * 77 + 5;
    for (int i = 0; i < N_ROUNDS * WIDTH; ++i) post[i] = i * 1234567ull + 3;
    for (int i = 0; i < SPARSE_TABLE_WORDS; ++i) sparse[i] = i * 0x9E3779B97F4A7C15ull % P;
    if (upload_constants(pre, sparse) != cudaSuccess) return 1;
    cudaMemcpyToSymbol(g_post, post, sizeof(post));
    cudaMemcpyToSymbol(g_pre, pre, sizeof(pre));
    const int reps = 20;
    for (int threads : {32, 128}) {
        probe<<<1, threads>>>(out, cycles, reps);
        if (cudaDeviceSynchronize() != cudaSuccess) return 1;
        printf("cycles, %d threads: mul_mod %lld, sbox7 %lld, shfl %lld, permute_split %lld, permute %lld\n", threads,
               cycles[0] / reps, cycles[1] / reps, cycles[2] / reps, cycles[3] / reps, cycles[4] / reps);
    }
    return 0;
}
