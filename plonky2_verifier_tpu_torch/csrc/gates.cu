// The levelized gate program (compiler/gates_torch.GateProgram) as one
// kernel: every lane's tape of extension values, its initial layout, every
// level's adds and multiplies, and the gather of the constraint slots.
//
// It replaces no Pallas kernel: the JAX package runs the same program as
// one lax.scan over levels inside the jax.jit of the verifier --
//   run_levelized   plonky2_verifier_tpu/compiler/gates_jax.py:225
//                   (add wave :277-283, mul wave :286-288).
// Run eagerly as plain PyTorch, each level is a chain of gathers, products
// and scatters: ~400 launches a level, 125 levels at the gate zoo.
//
// What a lane computes (bit for bit what GateProgram.forward_plain does):
// - the program's slots (n_tape) are slot 0 = 0, then the literal pool
//   (imaginary part 0), then the SEL, LKPSEL, CONST, WIRE and PI inputs at
//   their offsets, read where they lie through their strides; the slots
//   after them are the program's nodes, each written by exactly one op
//   before any op reads it (tests/test_torch_gates.py);
// - an add is add(a, mul(sign, b)) on both parts, sign in {1, p - 1}: NOT
//   add(a, b) or sub(a, b). Wires and constants are proof words and may be
//   x + p; mul(1, b) reduces such a word, and add with two non-canonical
//   operands would not (goldilocks.cuh restates ops/field.py's add, mul and
//   emul line for line). The kernel computes mul(sign, b) as the plain
//   version does, with sign the word 1 or p - 1;
// - a multiply is emul, its 7 ii term the product mul(ii, 7) (mul_small);
// - the padded arrays' dummy ops (which read and write slot 0) are not run,
//   and a gathered slot 0 reads zero (the verifier's padded constraint
//   layout relies on that).
//
// Bound: integer ALU work, as field.cu reckons it (16 int32 instructions a
// product, 4 an add): an add is a reduction, a negation and an add on each
// part, a multiply an emul, 5 products and 2 adds. The zoo's program (3,281
// adds, 3,703 multiplies) at 1024 lanes is ~4.1x10^8 instructions, ~0.025 ms
// on the H100 (tools/probe_kernels.gate_work); the bytes
// (inputs read once, outputs written once) are less. What a simple kernel
// pays instead is latency: the zoo's program is a chain 125 ops deep, most
// of its levels hold one op, and its tape of 7,849 slots (125.6 KB a lane)
// left one lane a block, one block an SM.
//
// Design: the host packs the program for the slots the caller gathers
// (compiler/gates_torch.pack_program, once a program and gather):
// - a schedule of its own: any topological order of the ops gives the same
//   bits (every node is written once and each op is a pure function of its
//   operands), so the ops are list-scheduled into steps of at most 64, the
//   ops that free a slot first, then by the longest chain below them. A
//   block has 64 threads a lane, so a step is one round of its threads,
//   and the cap spreads the wide levels' ops over the narrow chain: the
//   zoo keeps its 125 steps, of which 15 are narrow (70 under a cap of
//   128);
// - the tape packed by liveness: a slot is reused from the step after its
//   last read, an input's too, and an op whose value is gathered stores it
//   to its output column when it runs; an op whose value no later op reads
//   takes no slot. The zoo's tape falls from 7,849 slots to about 1,000
//   (16 KB a lane), so a block holds several lanes and an SM several
//   blocks;
// - a `tail` for the columns no op stores: a zero (slot 0), a literal, an
//   input, or a copy of a column gathered twice.
// A block holds `lanes` lanes' tapes, the parts apart, each as
// [slot][lane] words (a warp's threads take neighbouring lanes of one op:
// no bank conflict), and its threads stride over (op, lane) pairs, `lanes`
// a power of two so that a pair is split by shifts, not a division. A
// step whose pairs fit one warp runs on warp 0 alone, and two such steps in
// a row are ordered by __syncwarp; every other step ends in a block
// barrier. The zoo's narrow chain so costs no block barrier a step.
// - SHARED form: the tapes in dynamic shared memory, 16 bytes a slot a lane
//   (cudaFuncSetAttribute raises the limit where a block takes more than
//   48 KB, up to the card's 227 KB);
// - global form: the same code on tapes in device scratch that the wrapper
//   allocates (torch.empty), for a tape above the shared-memory limit.
//   __syncthreads and __syncwarp order global memory among their threads as
//   they order shared.
// The wrapper (kernels.KernelLibrary.gate_program) picks the form and the
// lanes a block from the tape's size.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

using gl::Ext;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int KINDS = 5;  // SEL, LKPSEL, CONST, WIRE, PI
enum { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2 };
constexpr unsigned NO_SLOT = 0xFFFF;

struct GateArgs {
    const uint64_t* in_re[KINDS];
    const uint64_t* in_im[KINDS];
    int64_t re_row[KINDS], re_col[KINDS], im_row[KINDS], im_col[KINDS];  // strides in words
    int32_t in_offset[KINDS], in_width[KINDS];                            // program slots
    const uint64_t* lits;     // (n_lits,) canonical literals at program slots 1 ...
    const int2* loads;        // (n_loads,) (tape slot, program slot): the initial tape
    const int32_t* step_off;  // (n_steps + 1,) into ops
    const uint2* ops;         // (src1 | src2 << 16, dst | code << 16): tape slots, dst NO_SLOT
                              // for none; code = kind | (column + 1) << 2, column -1 for none
    const int2* tail;         // (n_tail,) (column, source): source >= 0 a program slot
                              // below the nodes, else the column -source - 1
    uint64_t* out_re;         // (batch, n_out)
    uint64_t* out_im;
    uint64_t* scratch;        // global form: (blocks, 2, n_slots, lanes)
    int64_t batch;
    int32_t n_slots, n_loads, n_lits, n_steps, n_ops, n_out, n_tail, lanes;
    int32_t staged;           // ops and step_off copied into shared memory, after the tapes
};

// The value of a program slot below the nodes for one lane: 0 reads zero,
// 1 ... n_lits a literal (imaginary part 0), then the five input kinds,
// read where they lie through their strides.
__device__ __forceinline__ Ext source(const GateArgs& a, int slot, int64_t row) {
    Ext v = {0, 0};
    if (slot >= 1 && slot <= a.n_lits) {
        v.re = a.lits[slot - 1];
    } else {
#pragma unroll
        for (int k = 0; k < KINDS; ++k) {
            const int col = slot - a.in_offset[k];
            if (col >= 0 && col < a.in_width[k]) {
                v = {a.in_re[k][row * a.re_row[k] + col * a.re_col[k]], a.in_im[k][row * a.im_row[k] + col * a.im_col[k]]};
            }
        }
    }
    return v;
}

template <bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS) gate_program_kernel(const GateArgs a) {
    extern __shared__ uint64_t smem[];
    const int64_t lane0 = (int64_t)blockIdx.x * a.lanes;
    const int live = (int)(a.batch - lane0 < a.lanes ? a.batch - lane0 : a.lanes);
    const int64_t part = (int64_t)a.n_slots * a.lanes;
    uint64_t* re = SHARED ? smem : a.scratch + (int64_t)blockIdx.x * 2 * part;
    uint64_t* im = re + part;
    const int L = a.lanes, lane_bits = __ffs(L) - 1;  // L a power of two: a step's (op, lane) pairs by shifts

    // The program where it fits is copied after the tapes, so that no step waits on L2 for
    // its ops or its bounds; else it is read where it lies.
    const uint2* ops = a.ops;
    const int32_t* step_off = a.step_off;
    if (a.staged) {
        uint2* s_ops = (uint2*)(smem + (SHARED ? 2 * part : 0));
        int32_t* s_step = (int32_t*)(s_ops + a.n_ops);
        for (int i = threadIdx.x; i < a.n_ops; i += blockDim.x) s_ops[i] = a.ops[i];
        for (int i = threadIdx.x; i <= a.n_steps; i += blockDim.x) s_step[i] = a.step_off[i];
        ops = s_ops;
        step_off = s_step;
    }
    for (int i = threadIdx.x; i < a.n_loads * live; i += blockDim.x) {
        const int j = i / live, lane = i - j * live;
        const int2 l = a.loads[j];
        const Ext v = source(a, l.y, lane0 + lane);
        re[l.x * L + lane] = v.re;
        im[l.x * L + lane] = v.im;
    }
    __syncthreads();

    // A step's pairs are (op, lane) = (i >> lane_bits, i & (L - 1)), the lanes past `live` idle.
    for (int step = 0; step < a.n_steps; ++step) {
        const int o0 = step_off[step], pairs = (step_off[step + 1] - o0) << lane_bits;
        const bool warp_only = pairs <= 32;
        if (!warp_only || threadIdx.x < 32) {
            for (int i = threadIdx.x; i < pairs; i += warp_only ? 32 : blockDim.x) {
                const int lane = i & (L - 1);
                if (lane >= live) continue;  // the last block's missing lanes
                const uint2 o = ops[o0 + (i >> lane_bits)];
                const unsigned x = o.x & 0xFFFF, y = o.x >> 16, dst = o.y & 0xFFFF, kind = (o.y >> 16) & 3;
                const int col = (int)(o.y >> 18) - 1;
                const Ext u = {re[x * L + lane], im[x * L + lane]};
                const Ext w = {re[y * L + lane], im[y * L + lane]};
                Ext z;
                if (kind == OP_MUL) {
                    z = gl::emul(u, w);
                } else {  // add(a, mul(sign, b)) on both parts; never add(a, b)
                    const uint64_t sign = kind == OP_SUB ? gl::P - 1 : 1;
                    z = {gl::add(u.re, gl::mul(sign, w.re)), gl::add(u.im, gl::mul(sign, w.im))};
                }
                if (dst != NO_SLOT) {
                    re[dst * L + lane] = z.re;
                    im[dst * L + lane] = z.im;
                }
                if (col >= 0) {
                    const int64_t at = (lane0 + lane) * a.n_out + col;
                    a.out_re[at] = z.re;
                    a.out_im[at] = z.im;
                }
            }
        }
        if (warp_only && step + 1 < a.n_steps && ((step_off[step + 2] - step_off[step + 1]) << lane_bits) <= 32) {
            __syncwarp();  // warp 0 alone runs both steps
        } else {
            __syncthreads();
        }
    }

    // the columns no op stored, lane-major so that the stores of a warp are neighbours
    for (int i = threadIdx.x; i < a.n_tail * live; i += blockDim.x) {
        const int lane = i / a.n_tail, j = i - lane * a.n_tail;
        const int2 t = a.tail[j];
        const int64_t row = (lane0 + lane) * a.n_out;
        const Ext v = t.y >= 0 ? source(a, t.y, lane0 + lane) : Ext{a.out_re[row - t.y - 1], a.out_im[row - t.y - 1]};
        a.out_re[row + t.x] = v.re;
        a.out_im[row + t.x] = v.im;
    }
}

template <bool SHARED>
int launch(const GateArgs& a, int threads, cudaStream_t s) {
    const size_t bytes = (SHARED ? (size_t)16 * a.n_slots * a.lanes : 0) + (a.staged ? (size_t)8 * a.n_ops + 4 * (a.n_steps + 1) : 0);
    static size_t raised = 48 * 1024;  // a block may take this much without asking
    if (bytes > raised) {
        const cudaError_t err = cudaFuncSetAttribute(gate_program_kernel<SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        raised = bytes;
    }
    const unsigned blocks = (unsigned)((a.batch + a.lanes - 1) / a.lanes);
    gate_program_kernel<SHARED><<<blocks, threads, bytes, s>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// `args` is a GateArgs laid out by the wrapper (kernels.GateArgs), copied
// here into the launch's parameters; `shared` picks the form, `threads`
// the block's threads (a multiple of 32 up to 1024).
extern "C" int p2v_gate_program(const void* args, int shared, int threads, void* stream) {
    GateArgs a = *(const GateArgs*)args;
    if (threads < 32 || threads > MAX_THREADS || threads % 32 || a.lanes < 1 || (a.lanes & (a.lanes - 1)) || a.n_slots > (int)NO_SLOT) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.batch <= 0) return (int)cudaGetLastError();
    return shared ? launch<true>(a, threads, (cudaStream_t)stream) : launch<false>(a, threads, (cudaStream_t)stream);
}

// The most dynamic shared memory a block may take on the current device
// (227 KB on the H100), for the wrapper's choice of form.
extern "C" int p2v_gate_smem_limit() {
    int device = 0, bytes = 0;
    if (cudaGetDevice(&device) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
    return bytes;
}
