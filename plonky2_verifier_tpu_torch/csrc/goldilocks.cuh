// Goldilocks arithmetic (p = 2^64 - 2^32 + 1) with the exact semantics of
// the plain PyTorch field, plonky2_verifier_tpu_torch/ops/field.py, for the
// field kernels (field.cu) and the gate program (gates.cu). Every function
// takes any u64 words, canonical or not, and returns the bits the plain
// version returns for them:
//
// - `add` is ops/field.add: the wrapped sum, 2^32 - 1 (= 2^64 mod p) added
//   back where the sum wrapped, then one conditional subtraction of p.
//   With one canonical operand (every call in field.cu and gates.cu has
//   one) the result is canonical and exact mod p; with two words >= p it
//   need not be, and neither is the plain version's: the bits are the same
//   either way.
// - `mul` forms the exact 128-bit product (Hopper's native __umul64hi) and
//   reduces it as ops/field.reduce128 does: canonical for any (lo, hi).
// - `sub` is ops/field.sub: the wrapped difference, 2^32 - 1 taken off
//   where it borrowed (that adds p). Exact mod p for any words; canonical
//   where both operands are.
// - `emul` is ops/field.emul in F_p[X]/(X^2 - 7): re = add(rr, 7 ii) with
//   7 ii as the canonical product mul(ii, 7) (ops/field.mul_small),
//   im = add(ri, ir). Its form for a fixed point (`Point`) gives the same
//   words by other means (below).
//
// poseidon.cuh keeps its own lazily reduced arithmetic for the permutation;
// nothing here is shared with it.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;  // 2^64 mod p
constexpr uint64_t W = 7;                    // X^2 = W in the extension

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += EPSILON;  // wrapped past 2^64; cannot wrap again
    if (s >= P) s -= P;
    return s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    const uint64_t d = a - b;
    return a < b ? d - EPSILON : d;
}

__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    const uint64_t hi_hi = hi >> 32, hi_lo = hi & EPSILON;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPSILON;  // borrowed: take 2^32 - 1 (add p)
    const uint64_t t1 = hi_lo * EPSILON;  // < 2^64
    uint64_t t2 = t0 + t1;
    if (t2 < t1) t2 += EPSILON;
    if (t2 >= P) t2 -= P;
    return t2;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return reduce128(a * b, __umul64hi(a, b)); }

struct Ext {
    uint64_t re, im;
};

__device__ __forceinline__ Ext emul(Ext a, Ext b) {
    const uint64_t rr = mul(a.re, b.re), ii = mul(a.im, b.im);
    const uint64_t ri = mul(a.re, b.im), ir = mul(a.im, b.re);
    return {add(rr, mul(ii, W)), add(ri, ir)};
}

// GExt's + and - (ops/field.py): part by part
__device__ __forceinline__ Ext eadd(Ext a, Ext b) { return {add(a.re, b.re), add(a.im, b.im)}; }
__device__ __forceinline__ Ext esub(Ext a, Ext b) { return {sub(a.re, b.re), sub(a.im, b.im)}; }
// ops/field.escale: a base-field word times an extension element
__device__ __forceinline__ Ext escale(uint64_t s, Ext a) { return {mul(s, a.re), mul(s, a.im)}; }

// An extension matrix at any strides in words, both parts alike: element
// (row, col) at re[row * row_stride + col * col_stride] (im likewise). A
// vector is a matrix of one column. kernels.ExtView field for field.
struct ExtView {
    const uint64_t* re;
    const uint64_t* im;
    int64_t row, col;
};

__device__ __forceinline__ Ext at(const ExtView& m, int64_t row, int64_t col = 0) {
    const int64_t i = row * m.row + col * m.col;
    return {m.re[i], m.im[i]};
}

// A point a that multiplies many values (a Horner chain) with its
// 7 a.im formed once: emul(a, b) as add(a.re b.re, (7 a.im) b.im), four
// products. mul(a.im7, b.im) and mul(mul(a.im, b.im), 7) are both the
// canonical 7 a.im b.im mod p, so the words are emul's.
struct Point {
    uint64_t re, im, im7;  // im7 = mul(im, W)
};

__device__ __forceinline__ Point point(Ext a) { return {a.re, a.im, mul(a.im, W)}; }

__device__ __forceinline__ Ext emul(Point a, Ext b) {
    return {add(mul(a.re, b.re), mul(a.im7, b.im)), add(mul(a.re, b.im), mul(a.im, b.re))};
}

// Forms that reduce once (plonk.cu's p2v_partial_products and p2v_gate_filter call them):
// a sum of full products and words kept exact in three words, reduced to the
// canonical representative by one reduce192. Every operand may be any u64
// word, and every result is the canonical value of the exact expression, so
// where the forms above are exact mod p with a canonical result (mul, add
// with one canonical operand, emul) these give their words.
struct Wide {  // lo + hi 2^64 + top 2^128
    uint64_t lo, hi, top;
};

__device__ __forceinline__ Wide wide_mul(uint64_t a, uint64_t b) { return {a * b, __umul64hi(a, b), 0}; }

__device__ __forceinline__ Wide wide_add(Wide x, Wide y) {
    Wide s;
    asm("add.cc.u64 %0, %3, %6;\n\taddc.cc.u64 %1, %4, %7;\n\taddc.u64 %2, %5, %8;"
        : "=l"(s.lo), "=l"(s.hi), "=l"(s.top)
        : "l"(x.lo), "l"(x.hi), "l"(x.top), "l"(y.lo), "l"(y.hi), "l"(y.top));
    return s;
}

__device__ __forceinline__ Wide wide_add(Wide x, uint64_t y) {
    Wide s;
    asm("add.cc.u64 %0, %3, %6;\n\taddc.cc.u64 %1, %4, 0;\n\taddc.u64 %2, %5, 0;"
        : "=l"(s.lo), "=l"(s.hi), "=l"(s.top)
        : "l"(x.lo), "l"(x.hi), "l"(x.top), "l"(y));
    return s;
}

// 7 x as 8 x - x
__device__ __forceinline__ Wide wide_times7(Wide x) {
    const uint64_t lo = x.lo << 3, hi = (x.hi << 3) | (x.lo >> 61), top = (x.top << 3) | (x.hi >> 61);
    Wide s;
    asm("sub.cc.u64 %0, %3, %6;\n\tsubc.cc.u64 %1, %4, %7;\n\tsubc.u64 %2, %5, %8;"
        : "=l"(s.lo), "=l"(s.hi), "=l"(s.top)
        : "l"(lo), "l"(hi), "l"(top), "l"(x.lo), "l"(x.hi), "l"(x.top));
    return s;
}

// reduce128 with a third word: with 2^96 = -1 and 2^128 = -2^32 mod p,
// x = lo - (top 2^32 + hi_hi) + hi_lo (2^32 - 1); top < 2^32 - 1 keeps the
// subtrahend below p, so one p added where it borrows makes it good (every
// caller's top is at most 7 but p2v_gate_filter's sums', below 8 x 3072).
// reduce192({lo, hi, 0}) is reduce128(lo, hi).
__device__ __forceinline__ uint64_t reduce192(Wide x) {
    const uint64_t sub = (x.top << 32) | (x.hi >> 32), hi_lo = x.hi & EPSILON;
    uint64_t t0 = x.lo - sub;
    if (x.lo < sub) t0 -= EPSILON;  // borrowed: take 2^32 - 1 (add p)
    const uint64_t t1 = hi_lo * EPSILON;  // < 2^64
    uint64_t t2 = t0 + t1;
    if (t2 < t1) t2 += EPSILON;
    if (t2 >= P) t2 -= P;
    return t2;
}

// a b + c and a b + c + d (top <= 1), canonical: add(add(c, mul(a, b)), d)'s
// words wherever that is exact (one canonical operand in each add)
__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b, uint64_t c) { return reduce192(wide_add(wide_mul(a, b), c)); }
__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b, uint64_t c, uint64_t d) {
    return reduce192(wide_add(wide_add(wide_mul(a, b), c), d));
}

// emul with each part reduced once: re = a.re b.re + 7 a.im b.im (top <= 7),
// im = a.re b.im + a.im b.re (top <= 1), for any u64 words: emul's words.
__device__ __forceinline__ Ext emul_once(Ext a, Ext b) {
    return {reduce192(wide_add(wide_mul(a.re, b.re), wide_times7(wide_mul(a.im, b.im)))),
            reduce192(wide_add(wide_mul(a.re, b.im), wide_mul(a.im, b.re)))};
}

}  // namespace gl
