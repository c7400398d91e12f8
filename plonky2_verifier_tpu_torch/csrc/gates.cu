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
// - the tape (n_tape extension slots) starts as slot 0 = 0, then the
//   literal pool (imaginary part 0), then the SEL, LKPSEL, CONST, WIRE and
//   PI inputs at their offsets, read where they lie through their strides;
//   the slots after them are the program's nodes, each written by exactly
//   one op before any op reads it (tests/test_torch_gates.py);
// - an add is add(a, mul(sign, b)) on both parts, sign in {1, p - 1}: NOT
//   add(a, b) or sub(a, b). Wires and constants are proof words and may be
//   x + p; mul(1, b) reduces such a word, and add with two non-canonical
//   operands would not (goldilocks.cuh restates ops/field.py's add, mul and
//   emul line for line). The kernel computes mul(sign, b) as the plain
//   version does, with sign the word 1 or p - 1;
// - a multiply is emul, its 7 ii term the product mul(ii, 7) (mul_small);
// - the padded arrays' dummy ops (which read and write slot 0) are not run:
//   the host passes each level's real ops alone (compact lists with CSR
//   offsets), so slot 0 stays 0 and an output slot of 0 reads zero (the
//   verifier's padded constraint layout relies on that).
// An op of level l reads only slots of levels below l (a node's level is
// one more than its arguments' highest), and every slot is written once, so
// a level's adds and multiplies are independent of each other: they run as
// one pass, one barrier a level, in any order.
//
// Bound: integer ALU work, as field.cu reckons it (16 int32 instructions a
// product, 4 an add): an add is 2 products and 2 adds, a multiply an emul,
// 5 products and 2 adds. The zoo's program (3,281 adds, 3,703 multiplies)
// at 1024 lanes is ~4.7x10^8 instructions, ~0.03 ms on the H100; the bytes
// (inputs read once, outputs written once) are less. What a simple kernel
// pays instead is latency: a level is a barrier, and the zoo has 125.
//
// Design: a block holds `lanes` lanes' tapes, the parts apart, each as
// [slot][lane] words (a warp's threads take neighbouring lanes of one op:
// no bank conflict), and its threads stride over (op, lane) pairs.
// - SHARED form: the tapes in dynamic shared memory, 16 bytes a slot a lane
//   (the zoo's 7,849 slots are 125.6 KB: one lane a block, after
//   cudaFuncSetAttribute raises the limit to the card's 227 KB);
// - global form: the same code on tapes in device scratch that the wrapper
//   allocates (torch.empty), for a tape above the shared-memory limit.
//   __syncthreads orders global memory within a block as it orders shared.
// The wrapper (kernels.KernelLibrary.gate_program) picks the form and the
// lanes a block from the tape's size.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

using gl::Ext;

namespace {

constexpr int THREADS = 256;
constexpr int KINDS = 5;  // SEL, LKPSEL, CONST, WIRE, PI

struct GateArgs {
    const uint64_t* in_re[KINDS];
    const uint64_t* in_im[KINDS];
    int64_t re_row[KINDS], re_col[KINDS], im_row[KINDS], im_col[KINDS];  // strides in words
    int32_t in_offset[KINDS], in_width[KINDS];                            // tape slots
    const uint64_t* lits;     // (n_lits,) canonical literals at slots 1 ...
    const int32_t* add_off;   // (n_levels + 1,) into adds
    const int32_t* mul_off;   // (n_levels + 1,) into muls
    const int4* adds;         // (src1, src2, negate, dst): dst = src1 + (negate ? p - 1 : 1) * src2
    const int4* muls;         // (src1, src2, dst, unused): dst = src1 * src2
    const int32_t* out_slots; // (n_out,) tape slots gathered into the output columns
    uint64_t* out_re;         // (batch, n_out)
    uint64_t* out_im;
    uint64_t* scratch;        // global form: (blocks, 2, n_tape, lanes)
    int64_t batch;
    int32_t n_tape, n_init, n_lits, n_levels, n_out, lanes;
};

template <bool SHARED>
__global__ void __launch_bounds__(THREADS) gate_program_kernel(const GateArgs a) {
    extern __shared__ uint64_t smem[];
    const int64_t lane0 = (int64_t)blockIdx.x * a.lanes;
    const int live = (int)(a.batch - lane0 < a.lanes ? a.batch - lane0 : a.lanes);
    const int64_t part = (int64_t)a.n_tape * a.lanes;
    uint64_t* re = SHARED ? smem : a.scratch + (int64_t)blockIdx.x * 2 * part;
    uint64_t* im = re + part;
    const int L = a.lanes;

    // the initial tape: zero, literals, inputs (the node slots are written by their ops)
    for (int i = threadIdx.x; i < a.n_init * live; i += blockDim.x) {
        const int slot = i / live, lane = i - slot * live;
        const int64_t row = lane0 + lane;
        uint64_t r = 0, m = 0;
        if (slot >= 1 && slot <= a.n_lits) {
            r = a.lits[slot - 1];
        } else {
#pragma unroll
            for (int k = 0; k < KINDS; ++k) {
                const int col = slot - a.in_offset[k];
                if (col >= 0 && col < a.in_width[k]) {
                    r = a.in_re[k][row * a.re_row[k] + col * a.re_col[k]];
                    m = a.in_im[k][row * a.im_row[k] + col * a.im_col[k]];
                }
            }
        }
        re[slot * L + lane] = r;
        im[slot * L + lane] = m;
    }
    __syncthreads();

    for (int level = 0; level < a.n_levels; ++level) {
        const int a0 = a.add_off[level], n_add = a.add_off[level + 1] - a0;
        const int m0 = a.mul_off[level], n_ops = n_add + a.mul_off[level + 1] - m0;
        for (int i = threadIdx.x; i < n_ops * live; i += blockDim.x) {
            const int op = i / live, lane = i - op * live;
            if (op < n_add) {
                const int4 o = a.adds[a0 + op];
                const uint64_t sign = o.z ? gl::P - 1 : 1;
                const uint64_t r = gl::add(re[o.x * L + lane], gl::mul(sign, re[o.y * L + lane]));
                const uint64_t m = gl::add(im[o.x * L + lane], gl::mul(sign, im[o.y * L + lane]));
                re[o.w * L + lane] = r;
                im[o.w * L + lane] = m;
            } else {
                const int4 o = a.muls[m0 + op - n_add];
                const Ext x = {re[o.x * L + lane], im[o.x * L + lane]};
                const Ext y = {re[o.y * L + lane], im[o.y * L + lane]};
                const Ext z = gl::emul(x, y);
                re[o.z * L + lane] = z.re;
                im[o.z * L + lane] = z.im;
            }
        }
        __syncthreads();
    }

    // the output columns, lane-major so that the stores of a warp are neighbours
    for (int i = threadIdx.x; i < a.n_out * live; i += blockDim.x) {
        const int lane = i / a.n_out, j = i - lane * a.n_out;
        const int slot = a.out_slots[j];
        const int64_t at = (lane0 + lane) * a.n_out + j;
        a.out_re[at] = re[slot * L + lane];
        a.out_im[at] = im[slot * L + lane];
    }
}

}  // namespace

// The most dynamic shared memory a block may take on the current device
// (227 KB on the H100), for the wrapper's choice of form.
extern "C" int p2v_gate_smem_limit() {
    int device = 0, bytes = 0;
    if (cudaGetDevice(&device) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
    return bytes;
}

// `args` is a GateArgs laid out by the wrapper (kernels.GATE_ARGS), copied
// here into the launch's parameters; `shared` picks the form.
extern "C" int p2v_gate_program(const void* args, int shared, void* stream) {
    GateArgs a = *(const GateArgs*)args;
    if (a.batch > 0) {
        const unsigned blocks = (unsigned)((a.batch + a.lanes - 1) / a.lanes);
        cudaStream_t s = (cudaStream_t)stream;
        if (shared) {
            const size_t bytes = (size_t)16 * a.n_tape * a.lanes;
            static size_t raised = 48 * 1024;  // a block may take this much without asking
            if (bytes > raised) {
                const cudaError_t err = cudaFuncSetAttribute(gate_program_kernel<true>,
                                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
                if (err != cudaSuccess) return (int)err;
                raised = bytes;
            }
            gate_program_kernel<true><<<blocks, THREADS, bytes, s>>>(a);
        } else {
            gate_program_kernel<false><<<blocks, THREADS, 0, s>>>(a);
        }
    }
    return (int)cudaGetLastError();
}
