// Batched Poseidon-12 permutation: states (n, 12) -> (n, 12), u64 words, and
// the transcript scan built on it.
//
// Replaces plonky2_verifier_tpu/ops/pallas_poseidon.py  permutation
// (_poseidon_kernel), which carries the verifier's transcript scan, and the
// lax.scan around it (verifier_jax.py  _run_transcript).
//
// Bound: integer ALU work (W in poseidon.cuh); 96 bytes read and written per
// state. What a transcript step of n = 1024 states waits for is not
// throughput but the serial chain one thread walks, so there are two forms
// (poseidon.cuh) and the launcher picks by n:
// - split (n <= SPLIT_MAX_STATES): one state per 16-lane half of a warp, 128
//   threads a block, so 1024 states are 512 warps over all 132 SMs and a
//   thread's chain is one S-box and one MDS row a round;
// - thread (beyond): one state per thread, grid-stride over n.
// The switch sits where the split form stopped being the faster one on an
// H100: the thread form's time stays flat at one warp's walk until a few
// warps sit on every scheduler, while the split form's grows with n because
// it spends about four times the instructions a state. With the present
// round bodies (the thread form's partial rounds sparse, the split form's
// dense) the permutation's forms cross between 2^12 and 2^13 states (thread
// 0.036-0.038 ms up to 16384; split 0.030 ms at 4096, 0.047 at 8192, 0.087 at
// 16384), the scan's between 2^12 and 2^14 (thread 3.63 ms at 4096 and 3.72
// at 16384; split 2.58 and 9.33); tools/probe_kernels.py prints both forms'
// times.
//
// p2v_permutation_scan runs the whole transcript in one launch: for each of
// the n_perms steps of the static schedule, overwrite the masked lanes of
// the state from data[b, ov_idx[step, lane]], permute, and write the state
// to states[step, b, :]. The state never leaves its registers between steps.
// It uses the same two forms with the same switch on the batch size.
//
// The TPU kernel's lane-major (12, N) transposes and block padding were
// Mosaic layout rules and are not carried over: states stay row-major.
#include "poseidon.cuh"

using namespace p2v;

namespace {

constexpr int THREADS = 64;          // thread form: small blocks spread a batch over the SMs
constexpr int SPLIT_THREADS = 128;   // split form: 8 states a block
constexpr int STATES_PER_BLOCK = SPLIT_THREADS / SPLIT_LANES;
constexpr int64_t SPLIT_MAX_STATES = 8192;

// the split form's constants (kernels.folded_round_constants), which its
// threads index by their own lane
__device__ uint64_t g_post[N_ROUNDS * WIDTH];
__device__ uint64_t g_pre[WIDTH];

int g_resident_thread = 1, g_resident_scan = 1;

__global__ void __launch_bounds__(THREADS)
permutation_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        uint64_t s[WIDTH];
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) s[k] = in[i * WIDTH + k];
        permute(s);
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) out[i * WIDTH + k] = s[k];
    }
}

#ifdef P2V_COUNT_ROUNDS
// The pieces of one thread-form permutation as straight-line kernels, for
// counting its instructions in the SASS (kernels.sass_instruction_count).
// The round index r is a kernel argument, so the tables are read as the
// rolled loops read them. PIECE 0 loads and stores only; 1 adds round 0's
// constants and canonicalises; 2 is a full round (0-3, 26-28); 3 a sparse
// partial round; 4 one output of the initial matrix; 5 round 29 (no
// constants); 6 round 29 of a 2-to-1 compression (four rows); 7 the
// compression's first constants and canonicalisation of four lanes; 8 the
// carried constants after the last sparse round (`add_tail`). Every piece
// loads and stores the same 23 words a thread (piece 4's shift register
// beside the state), so piece 0's instructions are every piece's overhead.
constexpr int COUNT_WORDS = WIDTH + SPARSE;

template <int PIECE>
__global__ void count_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int r) {
    uint64_t s[WIDTH], o[SPARSE];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) s[k] = in[threadIdx.x * COUNT_WORDS + k];
#pragma unroll
    for (int k = 0; k < SPARSE; ++k) o[k] = in[threadIdx.x * COUNT_WORDS + WIDTH + k];
    if (PIECE == 1) {
        add_first_constants(s);
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) s[k] = canonical(s[k]);
    }
    if (PIECE == 2) {
        full_sbox(s);
        mds<WIDTH, WIDTH>(s, c_full + r * WIDTH);
    }
    if (PIECE == 3) sparse_round(s, r);
    if (PIECE == 4) initial_matrix_step(s, o, r);
    if (PIECE == 5 || PIECE == 6) {
        full_sbox(s);
        mds<PIECE == 5 ? WIDTH : 4, 0>(s, nullptr);
    }
    if (PIECE == 7) {
        add_first_constants<true>(s);
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = canonical(s[k]);
    }
    if (PIECE == 8) add_tail(s);
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) out[threadIdx.x * COUNT_WORDS + k] = s[k];
#pragma unroll
    for (int k = 0; k < SPARSE; ++k) out[threadIdx.x * COUNT_WORDS + WIDTH + k] = o[k];
}
template __global__ void count_kernel<0>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<1>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<2>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<3>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<4>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<5>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<6>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<7>(const uint64_t*, uint64_t*, int);
template __global__ void count_kernel<8>(const uint64_t*, uint64_t*, int);
#endif

__device__ __forceinline__ void load_post(uint64_t* post) {
    for (int k = threadIdx.x; k < N_ROUNDS * WIDTH; k += blockDim.x) post[k] = g_post[k];
    __syncthreads();
}

// One state per half-warp. Every thread of a block walks the same path
// (SplitLane in poseidon.cuh says why): a half-warp past the end recomputes
// the last state and stores the same words again.
__global__ void __launch_bounds__(SPLIT_THREADS)
permutation_split_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n) {
    __shared__ uint64_t post[N_ROUNDS * WIDTH];
    load_post(post);
    const SplitLane L = split_lane(g_pre);
    const int64_t stride = (int64_t)gridDim.x * STATES_PER_BLOCK;
    const int64_t first = (int64_t)blockIdx.x * STATES_PER_BLOCK;
    for (int64_t base = first; base < n; base += stride) {
        int64_t i = base + threadIdx.x / SPLIT_LANES;
        i = i < n ? i : n - 1;
        out[i * WIDTH + L.j] = permute_split(in[i * WIDTH + L.j], L, post);
    }
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(const uint64_t* __restrict__ data, const int64_t* __restrict__ ov_idx,
            const uint8_t* __restrict__ ov_mask, uint64_t* __restrict__ states, int64_t batch,
            int64_t n_data, int n_perms) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < batch; b += stride) {
        const uint64_t* row = data + b * n_data;
        uint64_t s[WIDTH];
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) s[k] = 0;
        for (int step = 0; step < n_perms; ++step) {
#pragma unroll
            for (int k = 0; k < WIDTH; ++k)
                if (ov_mask[step * WIDTH + k]) s[k] = row[ov_idx[step * WIDTH + k]];
            permute(s);
            uint64_t* o = states + ((int64_t)step * batch + b) * WIDTH;
#pragma unroll
            for (int k = 0; k < WIDTH; ++k) o[k] = s[k];
        }
    }
}

__global__ void __launch_bounds__(SPLIT_THREADS)
scan_split_kernel(const uint64_t* __restrict__ data, const int64_t* __restrict__ ov_idx,
                  const uint8_t* __restrict__ ov_mask, uint64_t* __restrict__ states, int64_t batch,
                  int64_t n_data, int n_perms) {
    __shared__ uint64_t post[N_ROUNDS * WIDTH];
    load_post(post);
    const SplitLane L = split_lane(g_pre);
    const int64_t stride = (int64_t)gridDim.x * STATES_PER_BLOCK;
    const int64_t first = (int64_t)blockIdx.x * STATES_PER_BLOCK;
    for (int64_t base = first; base < batch; base += stride) {
        int64_t b = base + threadIdx.x / SPLIT_LANES;
        b = b < batch ? b : batch - 1;
        const uint64_t* row = data + b * n_data;
        uint64_t x = 0;
        for (int step = 0; step < n_perms; ++step) {
            if (ov_mask[step * WIDTH + L.j]) x = row[ov_idx[step * WIDTH + L.j]];
            x = permute_split(x, L, post);
            states[((int64_t)step * batch + b) * WIDTH + L.j] = x;
        }
    }
}

unsigned split_grid(int64_t n) {
    const int64_t blocks = (n + STATES_PER_BLOCK - 1) / STATES_PER_BLOCK;
    const int64_t cap = (int64_t)g_sms * 16;  // 16 blocks of 4 warps fill an SM
    return (unsigned)(blocks < cap ? blocks : cap);
}

bool use_split(int64_t n, int form) { return form == 2 || (form == 0 && n <= SPLIT_MAX_STATES); }

}  // namespace

// pre: round 0's constants; post: the split form's (30, 12) table
// (kernels.folded_round_constants); sparse: the thread form's tables
// (kernels.sparse_round_tables, poseidon.cuh).
extern "C" int p2v_permutation_init(const void* pre, const void* post, const void* sparse) {
    cudaError_t e = upload_constants(pre, sparse);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_post, post, sizeof(uint64_t) * N_ROUNDS * WIDTH);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_pre, pre, sizeof(uint64_t) * WIDTH);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_resident_thread, permutation_kernel, THREADS, 0);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_resident_scan, scan_kernel, THREADS, 0);
    return (int)e;
}

// form: 0 picks by n, 1 forces the thread form, 2 the split form.
extern "C" int p2v_permutation(const void* in, void* out, int64_t n, int form, void* stream) {
    if (n > 0) {
        if (use_split(n, form))
            permutation_split_kernel<<<split_grid(n), SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
                (const uint64_t*)in, (uint64_t*)out, n);
        else
            permutation_kernel<<<balanced_grid(n, THREADS, g_resident_thread), THREADS, 0, (cudaStream_t)stream>>>(
                (const uint64_t*)in, (uint64_t*)out, n);
    }
    return (int)cudaGetLastError();
}

// data (batch, n_data), ov_idx (n_perms, 12) int64, ov_mask (n_perms, 12)
// bytes -> states (n_perms, batch, 12). form as above, picked by batch.
extern "C" int p2v_permutation_scan(const void* data, const void* ov_idx, const void* ov_mask, void* states,
                                    int64_t batch, int64_t n_data, int n_perms, int form, void* stream) {
    if (batch > 0 && n_perms > 0) {
        if (use_split(batch, form))
            scan_split_kernel<<<split_grid(batch), SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
                (const uint64_t*)data, (const int64_t*)ov_idx, (const uint8_t*)ov_mask, (uint64_t*)states, batch,
                n_data, n_perms);
        else
            scan_kernel<<<balanced_grid(batch, THREADS, g_resident_scan), THREADS, 0, (cudaStream_t)stream>>>(
                (const uint64_t*)data, (const int64_t*)ov_idx, (const uint8_t*)ov_mask, (uint64_t*)states, batch,
                n_data, n_perms);
    }
    return (int)cudaGetLastError();
}
