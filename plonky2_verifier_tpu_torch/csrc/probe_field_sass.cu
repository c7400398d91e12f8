// Straight-line chains of goldilocks.cuh's ops, for counting the SASS
// instructions one op executes (tools/probe_kernels.py --stages compiles
// this file to a cubin and reads it with cuobjdump; nothing launches it):
// count_kernel<OP, N> loads two values, applies op OP N times, each on the
// last two results (x = op(x, y), then y = op(y, x), ...), and stores both.
// The chains of N = 8 and N = 4 differ by 4 ops and by nothing else, so an
// op executes (count(8) - count(4)) / 4 instructions as the compiler emits
// it inside a dependent chain. OP: 0 mul, 1 add, 2 sub, 3 emul, 4 emul by
// a gl::Point (its 7 im formed once), 5 escale, and the forms that reduce
// once (csrc/plonk.cu's partial products): 6 mul_add (a b + c), 7 mul_add
// of two words (a b + c + d), 8 emul_once.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

using gl::Ext;

template <int OP>
__device__ __forceinline__ Ext apply(Ext a, Ext b, const gl::Point& q) {
    if constexpr (OP == 0) return {gl::mul(a.re, b.re), a.im};
    if constexpr (OP == 1) return {gl::add(a.re, b.re), a.im};
    if constexpr (OP == 2) return {gl::sub(a.re, b.re), a.im};
    if constexpr (OP == 3) return gl::emul(a, b);
    if constexpr (OP == 4) return gl::emul(q, a);
    if constexpr (OP == 5) return gl::escale(b.re, a);
    if constexpr (OP == 6) return {gl::mul_add(a.re, b.re, a.im), a.im};
    if constexpr (OP == 7) return {gl::mul_add(a.re, b.re, a.im, b.im), a.im};
    if constexpr (OP == 8) return gl::emul_once(a, b);
    return a;
}

template <int OP, int N>
__global__ void count_kernel(const uint64_t* in, uint64_t* out) {
    const int t = threadIdx.x;
    Ext x = {in[4 * t], in[4 * t + 1]}, y = {in[4 * t + 2], in[4 * t + 3]};
    const gl::Point q = gl::point({in[0], in[1]});
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if (i & 1) {
            y = apply<OP>(y, x, q);
        } else {
            x = apply<OP>(x, y, q);
        }
    }
    out[4 * t] = x.re;
    out[4 * t + 1] = x.im;
    out[4 * t + 2] = y.re;
    out[4 * t + 3] = y.im;
}

#define P2V_COUNT(OP) template __global__ void count_kernel<OP, 4>(const uint64_t*, uint64_t*); \
                      template __global__ void count_kernel<OP, 8>(const uint64_t*, uint64_t*);
P2V_COUNT(0)
P2V_COUNT(1)
P2V_COUNT(2)
P2V_COUNT(3)
P2V_COUNT(4)
P2V_COUNT(5)
P2V_COUNT(6)
P2V_COUNT(7)
P2V_COUNT(8)
