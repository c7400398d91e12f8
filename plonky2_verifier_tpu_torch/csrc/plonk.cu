// Two stages of the Plonk checks at zeta, one launch each a forward:
// p2v_partial_products (L0 and the partial products) and p2v_lookup_checks
// (the lookup argument).
//
// No Pallas kernel: the JAX package's _plonk_checks is part of one jax.jit
// program, and XLA fuses the same arithmetic into a few loops --
//   L0 and the partial products  plonky2_verifier_tpu/verifier_jax.py:345-385
//   the lookup argument          plonky2_verifier_tpu/verifier_jax.py:468-642
//                                (lax.scan for the leave-one-out products,
//                                the RE Horner and the table Horner).
// Run eagerly as plain PyTorch (verifier_torch.partial_products_plain,
// lookup_checks_plain) they were ~1,900 launches a forward and, on the gate
// zoo, most of its 14,000 launches beyond fibonacci's.
//
// Bits: every kernel mirrors the plain version's field ops (goldilocks.cuh
// has ops/field.py's add, sub, mul and emul on any u64 words). Where it
// takes another order -- products of a chunk one after the other rather than
// a halving tree, the leave-one-out sums by a running (product, sum) pair
// rather than prefix and suffix products -- every operand is a canonical
// product or a sum of canonical words, so the value is the same and
// canonical, hence the same word. Proof words (which may be x + p) enter
// products and the adds and subtractions of the plain version, in its order.
//
// p2v_partial_products: a thread a (b, round, chunk). The chunk's numerator
// and denominator products over its maxdeg routed wires,
//   w + beta k_i zeta + gamma  and  w + beta sigma + gamma,
// then current[c] num - current[c + 1] den with current = [z, partial
// products ..., z(omega zeta)]; chunk 0's thread also writes
// L0(zeta)(z - 1), L0 = (zeta^n - 1) / (n (zeta - 1)) from the forward's
// zeta^n and inverse (verifier_torch.TorchVerifier._powers_and_inverses).
// Output: the constraint vector's head, (B, r + r n_chunks), [L0(z - 1) a
// round] ++ [the checks of round 0's chunks, of round 1's, ...].
// Bound (chip_smoke.partial_products_work): integer ALU work, the least the
// function needs: a wire's numerator term beta k_i (a product), its escale
// of zeta (2) and 3 adds, its denominator term an escale of sigma (2) and 3
// adds; a chunk's two products maxdeg - 1 emuls each, the two emuls by
// current and a subtraction; L0 an emul a lane and one a round. Against the
// bytes: each opening and challenge word read once, each output written once.
//
// p2v_lookup_checks: a thread a (b, round, j), j < n_sldc an SLDC chunk
// (its two transition equations), j = n_sldc the RE transition with the
// three single equations, j > n_sldc a table's final RE (the padded table,
// the template's constant on the card, as a Horner chain in delta). The
// leave-one-out sums of a chunk of terms t_i (alpha - combo) by the running
// pair P' = P t, S' = S t + m P (m = 1 for the lookup slots, the
// multiplicity for the table slots): sum_i m_i prod_{l != i} t_l without
// the prefix and suffix arrays. Output (B, r (4 + luts + 2 n_sldc)), a round
// after the other, each [last_sldc, init_sum, init_re] ++ finals ++
// [re_trans] ++ (sum_trans, ldc_trans) a chunk, as lookup_checks_plain.
// Bound (chip_smoke.lookup_work): integer ALU work, counted in the running
// pair's form (the least this code knows): a lookup slot's combo (2
// products, 2 adds), its term (2 adds) and the pair's 2 emuls and add; a
// table slot the same and the emul by its multiplicity; an RE step a combo
// and an escale with its adds; a table row 2 products and 2 adds; the
// equations' emuls. Against the bytes: the openings, challenges and padded
// tables read once, each output written once.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

using gl::Ext;
using gl::ExtView;

namespace {

constexpr int PLONK_THREADS = 256;

// kernels.PartialProductArgs field for field
struct PartialProductArgs {
    ExtView zeta_n, l0_den_inv, zeta;          // (B,)
    ExtView zs, zs_next, pps, wires, sigmas;   // (B, r), (B, r), (B, r npp), (B, ns), (B, ns)
    const uint64_t* betas;                     // (B, r) contiguous
    const uint64_t* gammas;
    const uint64_t* k_is;                      // (ns,)
    uint64_t* out_re;                          // (B, r + r n_chunks) contiguous
    uint64_t* out_im;
    int64_t batch;
    int32_t r, maxdeg, n_chunks, npp;
};

__global__ void __launch_bounds__(PLONK_THREADS) partial_products_kernel(const PartialProductArgs a) {
    const int64_t t = (int64_t)blockIdx.x * PLONK_THREADS + threadIdx.x;
    const int64_t per_lane = (int64_t)a.r * a.n_chunks;
    if (t >= a.batch * per_lane) return;
    const int64_t b = t / per_lane;
    const int rc = (int)(t - b * per_lane), round = rc / a.n_chunks, c = rc - round * a.n_chunks;
    const int64_t width = a.r + per_lane;
    const uint64_t beta = a.betas[b * a.r + round], gamma = a.gammas[b * a.r + round];
    const Ext one = {1, 0}, zeta = gl::at(a.zeta, b);
    const Ext z = gl::at(a.zs, b, round);
    if (c == 0) {  // L0(zeta)(z - 1)
        const Ext lag0 = gl::emul(gl::esub(gl::at(a.zeta_n, b), one), gl::at(a.l0_den_inv, b));
        const Ext e = gl::emul(lag0, gl::esub(z, one));
        a.out_re[b * width + round] = e.re;
        a.out_im[b * width + round] = e.im;
    }
    Ext num = one, den = one;
    for (int d = 0; d < a.maxdeg; ++d) {
        const int64_t i = (int64_t)c * a.maxdeg + d;
        const Ext w = gl::at(a.wires, b, i), sigma = gl::at(a.sigmas, b, i);
        const Ext bz = gl::escale(gl::mul(beta, a.k_is[i]), zeta), bs = gl::escale(beta, sigma);
        num = gl::emul(num, {gl::add(gl::add(w.re, bz.re), gamma), gl::add(w.im, bz.im)});
        den = gl::emul(den, {gl::add(gl::add(w.re, bs.re), gamma), gl::add(w.im, bs.im)});
    }
    const Ext prev = c == 0 ? z : gl::at(a.pps, b, (int64_t)round * a.npp + c - 1);
    const Ext next = c == a.n_chunks - 1 ? gl::at(a.zs_next, b, round) : gl::at(a.pps, b, (int64_t)round * a.npp + c);
    const Ext e = gl::esub(gl::emul(prev, num), gl::emul(next, den));
    a.out_re[b * width + a.r + rc] = e.re;
    a.out_im[b * width + a.r + rc] = e.im;
}

// kernels.LookupArgs field for field
struct LookupArgs {
    ExtView sels;              // (B, 4 + luts): the lookup selectors
    ExtView wires;             // (B, num_wires)
    ExtView zs, zs_next;       // (B, r n_polys): [RE, SLDC_0, ...] a round
    const uint64_t* deltas;    // (B, r, 4) contiguous: (a, b, alpha, delta) a round
    const uint64_t* coeffs;    // (rows, 2) contiguous: the padded tables' (input, output) rows
    const int64_t* table_off;  // (luts + 1,): table k's rows are table_off[k] ... table_off[k + 1] - 1
    uint64_t* out_re;          // (B, r width) contiguous
    uint64_t* out_im;
    int64_t batch;
    int32_t r, luts, n_polys, num_lu, num_lut, lu_deg, lut_deg;
};

// inp + c out, alpha - that (the chunked terms' order in lookup_checks_plain)
__device__ __forceinline__ Ext combo(const LookupArgs& a, int64_t b, int64_t inp, uint64_t c) {
    const Ext x = gl::at(a.wires, b, inp), y = gl::at(a.wires, b, inp + 1);
    return gl::eadd(x, gl::escale(c, y));
}

__device__ __forceinline__ Ext alpha_minus(uint64_t alpha, Ext x) { return gl::esub({alpha, 0}, x); }

__global__ void __launch_bounds__(PLONK_THREADS) lookup_checks_kernel(const LookupArgs a) {
    const int64_t t = (int64_t)blockIdx.x * PLONK_THREADS + threadIdx.x;
    const int n_sldc = a.n_polys - 1;
    const int jobs = n_sldc + 1 + a.luts;  // a round's threads
    const int64_t per_lane = (int64_t)a.r * jobs;
    if (t >= a.batch * per_lane) return;
    const int64_t b = t / per_lane;
    const int rj = (int)(t - b * per_lane), round = rj / jobs, j = rj - round * jobs;
    const uint64_t* d = a.deltas + (b * a.r + round) * 4;
    const uint64_t ca = d[0], cb = d[1], alpha = d[2], delta = d[3];
    const int width = 4 + a.luts + 2 * n_sldc;
    const int64_t row = b * a.r * width + (int64_t)round * width;  // this round's first output
    const int64_t z0 = (int64_t)round * a.n_polys;  // this round's RE column
    const Ext one = {1, 0}, zero = {0, 0}, re = gl::at(a.zs, b, z0);
    auto put = [&](int col, Ext e) {
        a.out_re[row + col] = e.re;
        a.out_im[row + col] = e.im;
    };
    if (j < n_sldc) {  // chunk j's sum and LDC transitions
        const Ext prev = j == 0 ? gl::at(a.zs_next, b, z0 + n_sldc) : gl::at(a.zs, b, z0 + j);
        const Ext dmin = gl::esub(gl::at(a.zs, b, z0 + 1 + j), prev);
        Ext lu_p = one, lu_s = zero;
        const int lu_end = min((j + 1) * a.lu_deg, a.num_lu);
        for (int i = j * a.lu_deg; i < lu_end; ++i) {
            const Ext term = alpha_minus(alpha, combo(a, b, 2 * i, ca));
            lu_s = gl::eadd(gl::emul(lu_s, term), lu_p);
            lu_p = gl::emul(lu_p, term);
        }
        Ext lut_p = one, lut_s = zero;
        const int lut_end = min((j + 1) * a.lut_deg, a.num_lut);
        for (int i = j * a.lut_deg; i < lut_end; ++i) {
            const Ext term = alpha_minus(alpha, combo(a, b, 3 * i, ca));
            lut_s = gl::eadd(gl::emul(lut_s, term), gl::emul(gl::at(a.wires, b, 3 * i + 2), lut_p));
            lut_p = gl::emul(lut_p, term);
        }
        put(4 + a.luts + 2 * j, gl::emul(gl::at(a.sels, b, 0), gl::esub(gl::emul(lut_p, dmin), lut_s)));
        put(5 + a.luts + 2 * j, gl::emul(gl::at(a.sels, b, 1), gl::eadd(gl::emul(lu_p, dmin), lu_s)));
    } else if (j == n_sldc) {  // the RE transition, and the three single equations
        Ext cur = gl::at(a.zs_next, b, z0);
        for (int k = 0; k < a.num_lut; ++k) cur = gl::eadd(gl::escale(delta, cur), combo(a, b, 3 * k, cb));
        put(3 + a.luts, gl::emul(gl::at(a.sels, b, 0), gl::esub(re, cur)));
        put(0, gl::emul(gl::at(a.sels, b, 3), gl::at(a.zs, b, z0 + n_sldc)));
        put(1, gl::emul(gl::at(a.sels, b, 2), gl::at(a.zs, b, z0 + 1)));
        put(2, gl::emul(gl::at(a.sels, b, 2), re));
    } else {  // table k's final RE: its (input, output) columns as polynomials in delta
        const int k = j - n_sldc - 1;
        uint64_t acc_in = 0, acc_out = 0;
        for (int64_t i = a.table_off[k]; i < a.table_off[k + 1]; ++i) {
            acc_in = gl::add(gl::mul(delta, acc_in), a.coeffs[2 * i]);
            acc_out = gl::add(gl::mul(delta, acc_out), a.coeffs[2 * i + 1]);
        }
        const uint64_t expected = gl::add(acc_in, gl::mul(cb, acc_out));
        put(3 + k, gl::emul(gl::at(a.sels, b, 4 + k), gl::esub(re, {expected, 0})));
    }
}

unsigned blocks_for(int64_t threads) { return (unsigned)((threads + PLONK_THREADS - 1) / PLONK_THREADS); }

}  // namespace

extern "C" int p2v_partial_products(const void* args, void* stream) {
    const PartialProductArgs a = *(const PartialProductArgs*)args;
    if (a.batch < 0 || a.r < 0 || a.maxdeg < 1 || a.n_chunks < 1 || a.npp != a.n_chunks - 1) return (int)cudaErrorInvalidValue;
    const int64_t threads = a.batch * a.r * a.n_chunks;
    if (threads >= INT32_MAX) return (int)cudaErrorInvalidValue;
    if (threads > 0) partial_products_kernel<<<blocks_for(threads), PLONK_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int p2v_lookup_checks(const void* args, void* stream) {
    const LookupArgs a = *(const LookupArgs*)args;
    if (a.batch < 0 || a.r < 0 || a.luts < 0 || a.n_polys < 2 || a.num_lu < 0 || a.num_lut < 0 || a.lu_deg < 1 || a.lut_deg < 1)
        return (int)cudaErrorInvalidValue;
    const int64_t threads = a.batch * a.r * (a.n_polys + a.luts);
    if (threads >= INT32_MAX) return (int)cudaErrorInvalidValue;
    if (threads > 0) lookup_checks_kernel<<<blocks_for(threads), PLONK_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
