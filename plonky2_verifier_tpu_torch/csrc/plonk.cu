// Three stages of the Plonk checks at zeta, one launch each a forward:
// p2v_partial_products (L0 and the partial products), p2v_lookup_checks
// (the lookup argument) and p2v_gate_filter (the gate constraints filtered
// by their gates' selectors and summed).
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
// takes another order -- a chunk's products by a shuffle tree of another
// shape than the plain version's halving tree, the leave-one-out sums by a
// running (product, sum) pair rather than prefix and suffix products --
// every operand is a canonical product or a sum of canonical words, so the
// value is the same and canonical, hence the same word. Proof words (which
// may be x + p) enter products and the adds and subtractions of the plain
// version, in its order.
//
// p2v_partial_products: L0(zeta)(z - 1) a round and the
// partial-product checks, verifier_jax.py:345-385 (plain:
// verifier_torch.partial_products_plain). A group of L lanes inside one warp
// a (b, round, chunk), L = maxdeg / 2 rounded up to a power of two, at most
// 32 (kernels.partial_products_lanes, passed as lane_bits): two wires a
// lane read fastest of 1, 2, 4 and 8 at the main path's shape, as did a
// launch bound of 3 blocks an SM of 1, 3 and 4 (tools/probe_kernels.py
// --pp-lanes; PERF.md §6). Lane l forms the terms of the chunk's routed
// wires l, l + L, ..., each wire's
//   w + k_i (beta zeta) + gamma  and  w + beta sigma + gamma
// independent of the others (beta zeta formed once a round; four products,
// each added to its words and reduced once, gl::mul_add), and multiplies
// them in that order; a lane past maxdeg holds 1, as tree_prod_last pads
// with 1. The group's (numerator, denominator) pairs meet by shuffles in
// log2 L levels of one emul a lane: at level 0 lane 2k keeps the
// numerators' product of lanes 2k and 2k + 1 and lane 2k + 1 the
// denominators', at level j >= 1 lane l joins lane l + 2^j's, so lane 0
// ends with the chunk's numerator product and lane 1 with its
// denominator's (the association of the pairs' tree,
// check_field_kernels.partial_products_rows_plain). Lane 0 multiplies by
// current[c] and lane 1 by current[c + 1] (current = [z, partial products
// ..., z(omega zeta)]) in one emul, and lane 0 writes the difference. A
// thread of its own a (b, round), in warps after the groups', writes
// L0(zeta)(z - 1), L0 = (zeta^n - 1) / (n (zeta - 1)) from the forward's
// zeta^n and inverse, so that no group's warp waits on its two dependent
// emuls. Neighbouring lanes read neighbouring wire,
// sigma and k_i columns of one b. Every extension product is
// gl::emul_once (each part reduced once from an exact three-word sum).
// Output: the constraint vector's head, (B, r + r n_chunks), [L0(z - 1) a
// round] ++ [the checks of round 0's chunks, of round 1's, ...].
// Bits: every op of this function is exact mod p for any u64 words (mul and
// the once-reduced forms reduce the full sums; add(add(w, product), gamma)
// has a canonical operand in each add; sub is exact where the subtrahend is
// at most the minuend + p: z - 1, zeta^n - 1 and the difference of two
// canonical products), and each result is canonical. So every output word
// is the canonical value of the exact expression, whatever the order of the
// products, the tree or the reduction: the plain version's word, also where
// proof words are y + p (tests/test_torch_stages.py and
// tests/test_torch_noncanonical.py hold it).
// Bound (chip_smoke.partial_products_work): integer ALU work, the least the
// function needs: beta zeta a round (2 products); a wire's numerator term
// k_i times it (2) and 3 adds, its denominator term an escale of sigma (2)
// and 3 adds; a chunk's two products maxdeg - 1 emuls each, the two emuls
// by current and a subtraction; L0 an emul a lane and one a round. Against
// the bytes: each opening and challenge word read once, each output written
// once. partial_products_work also counts the kernel's own ops: every lane
// of a group forms beta zeta, its terms, its chain, the tree and the last
// emul, padding lanes too.
//
// p2v_lookup_checks: the equations of a (b, round) spread over three kinds
// of thread, each kind in warps of its own (the grid is three regions, each
// a whole number of warps: every warp runs one body), so that no warp runs
// the three bodies one after the other, and with more threads than jobs, so
// that every SM has several warps (the first form, a thread a (b, round,
// job), left 2 warps a scheduler and ran every body in every warp):
// - an SLDC chunk j: 2^chunk_bits lanes. Lane l runs the running pair
//   P' = P t, S' = S t + m P from (1, 0) over the chunk's slots l, l + L,
//   ... of each kind (t = alpha - combo; m = 1 for the lookup slots, the
//   multiplicity for the table slots), then the lanes' pairs meet by warp
//   shuffles: (P1, S1) o (P2, S2) = (P1 P2, S1 P2 + P1 S2), associative and
//   commutative, so P = prod_i t_i and S = sum_i m_i prod_{l != i} t_l for
//   any split. Lane 0 writes the chunk's two transition equations.
// - the RE transition: 2^re_bits lanes. cur = delta^n re_next + sum_k
//   delta^(n - 1 - k) combo_b(k) over the n = num_lut table slots is a
//   Horner sum in delta of the n + 1 values u_0 = combo_b(n - 1), ...,
//   u_(n-1) = combo_b(0), u_n = re_next in ascending powers; segment s takes
//   u_s, u_(s+S), ... in q = delta^S, and a shuffle tree joins the segments
//   by delta^(2^j) (csrc/field.cu's p2v_horner does the same). Lane 0
//   writes the RE transition and the three single equations.
// - a table's final RE: 2^table_bits lanes, the same segmented Horner in
//   delta over its padded (input, output) rows, both columns at once; lane 0
//   writes expected = input + b output against re.
// The wrapper (kernels.lookup_split) picks the lanes: the fewest (a power of
// two up to a warp) that leave a lane at most LOOKUP_SLOTS_A_LANE slots of
// each kind or LOOKUP_VALUES_A_SEGMENT values of a Horner sum, a table's
// for the longest table; the zoo's (7 + 5 slots a chunk, 27 RE values, one
// table of 26 rows) takes 2, 4 and 4.
// Output (B, r (4 + luts + 2 n_sldc)), a round after the other, each
// [last_sldc, init_sum, init_re] ++ finals ++ [re_trans] ++ (sum_trans,
// ldc_trans) a chunk, as lookup_checks_plain.
// Bits: a combo is add(raw wire, canonical product), exact and canonical;
// alpha - combo takes two canonical words; every product is canonical; so
// every value that the split reassociates (the pairs, the segments and their
// tree, re_next's product by a power of delta, or add(re_next, 0) where it
// is a segment's only value: the same element) is the canonical
// representative of the plain version's sum, hence its word. The ops that
// touch raw proof words are the plain version's, operand for operand:
// sldc - prev (two proof words: ops/field.sub is not exact mod p where the
// subtrahend is a word y + p above the minuend + p, and the JAX package's
// sub is the same; the port keeps those bits), re - cur and re - expected
// (cur and expected canonical: num_lut >= 1, so cur is never re_next
// itself), and the products by the selectors.
// Bound (chip_smoke.lookup_work): integer ALU work, counted in the running
// pair's form (the least this code knows): a lookup slot's combo (2
// products, 2 adds), its term (2 adds) and the pair's 2 emuls and add; a
// table slot the same and the emul by its multiplicity; an RE step a combo
// and an escale with its adds; a table row 2 products and 2 adds; the
// equations' emuls. Against the bytes: the openings, challenges and padded
// tables read once, each output written once. The split adds the pairs'
// meetings (3 emuls a pair a tree level), the segments' powers of delta and
// their tree (lookup_work prints the kernel's own count).
//
// p2v_gate_filter: Plonky2's gate filter, compute_filter and the filtered
// sum of evaluate_gate_constraints, verifier_jax.py:393-418 (plain:
// verifier_torch.gate_filter_plain). For lane b and constraint slot c
//   acc[b, c] = sum_k sel_k(b) cons[b, k n_gc + c],
//   sel_k(b) = prod_{j : mask[k, j]} (consts[k, j] - x_b[cols[k]]),
// k over the L live gates (those with constraints), cons the gate
// program's outputs in the padded (L, n_gc) layout, x the gate-selector
// columns of openings1 read where they lie. Run as plain PyTorch this was
// ~190 passes over (B, L, n_gc) tensors a forward (41 ms of the gate zoo's
// at 16,384) and a Python-list gather that synchronised with the host twice.
// A block takes `lanes` lanes: its threads first form each lane's L
// selector values into shared memory (a thread a (lane, gate): the first
// live factor, then one emul a further one, as tree_prod_last's product),
// then a thread a (lane, c) sums over the gates, neighbouring threads on
// neighbouring c, so each gate's row of cons is read once, coalesced. The
// sum is kept exact in three words a part, sum_k s.re v.re + 7 sum_k s.im
// v.im and sum_k (s.re v.im + s.im v.re), and reduced once (goldilocks.cuh's
// Wide forms: top < 8 L, far below 2^32 - 1 for any L the wrapper takes).
// Bits: sel_k is consts - x by ops/field.sub on the raw proof word (not
// exact mod p where x is a word y + p above consts + p, as the plain and
// the JAX package's sub; tests/test_torch_noncanonical.py), multiplied in
// another order than the halving tree; every product reduces the exact
// product of its words, so sel_k's value mod p is the plain version's, and
// the plain emul by the constraint and its sum are canonical and exact mod
// p: the canonical value of the exact sum, this kernel's word. Where a row
// has one live slot sel_k is the raw sub word itself, as the plain chain's
// where nothing multiplies it; the sum reduces its product alike.
// Bound (chip_smoke.gate_filter_work): B L n_gc terms, each an emul (5
// products, 2 adds) and 2 adds of the sum, beside L selector products of
// span factors a lane; against the bytes, cons and the selector columns
// read once, the output written once. The zoo at 16,384: ~0.150 ms by
// operations, 0.135 by bytes.
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
    int32_t lane_bits;  // 2^lane_bits lanes a chunk, at most a warp (kernels.partial_products_lanes)
};

constexpr unsigned ALL = 0xffffffffu;

__host__ __device__ __forceinline__ int64_t whole_warps(int64_t threads) { return (threads + 31) & ~(int64_t)31; }

__device__ __forceinline__ Ext shfl_down(Ext x, int by, int width) {
    return {(uint64_t)__shfl_down_sync(ALL, (unsigned long long)x.re, by, width), (uint64_t)__shfl_down_sync(ALL, (unsigned long long)x.im, by, width)};
}

__device__ __forceinline__ uint64_t shfl_down(uint64_t x, int by, int width) {
    return (uint64_t)__shfl_down_sync(ALL, (unsigned long long)x, by, width);
}

__device__ __forceinline__ Ext shfl_xor(Ext x, int mask, int width) {
    return {(uint64_t)__shfl_xor_sync(ALL, (unsigned long long)x.re, mask, width), (uint64_t)__shfl_xor_sync(ALL, (unsigned long long)x.im, mask, width)};
}

// wire i's numerator and denominator terms in a round: w + k_i (beta zeta) + gamma, w + beta sigma + gamma
__device__ __forceinline__ void wire_terms(const PartialProductArgs& a, int64_t b, int64_t i, uint64_t beta, uint64_t gamma, Ext bz,
                                           Ext& num, Ext& den) {
    const Ext w = gl::at(a.wires, b, i), sigma = gl::at(a.sigmas, b, i);
    const uint64_t k = a.k_is[i];
    num = {gl::mul_add(k, bz.re, w.re, gamma), gl::mul_add(k, bz.im, w.im)};
    den = {gl::mul_add(beta, sigma.re, w.re, gamma), gl::mul_add(beta, sigma.im, w.im)};
}

// current[k] of a round, current = [z, partial products ..., z(omega zeta)]
__device__ __forceinline__ Ext current(const PartialProductArgs& a, int64_t b, int round, int k) {
    if (k == 0) return gl::at(a.zs, b, round);
    return k == a.n_chunks ? gl::at(a.zs_next, b, round) : gl::at(a.pps, b, (int64_t)round * a.npp + k - 1);
}

// L0(zeta)(z - 1) of a (b, round)
__device__ __forceinline__ void l0_term(const PartialProductArgs& a, int64_t q) {
    const int64_t b = q / a.r;
    const int round = (int)(q - b * a.r);
    const Ext one = {1, 0};
    const Ext lag0 = gl::emul_once(gl::esub(gl::at(a.zeta_n, b), one), gl::at(a.l0_den_inv, b));
    const Ext e = gl::emul_once(lag0, gl::esub(gl::at(a.zs, b, round), one));
    const int64_t at = b * (a.r + (int64_t)a.r * a.n_chunks) + round;
    a.out_re[at] = e.re;
    a.out_im[at] = e.im;
}

// The grid is two regions of whole warps: groups of 2^a.lane_bits lanes a
// (b, round, chunk) -- with ALL_ROUNDS (the probe's second form) a (b,
// chunk) whose lanes run the rounds one after the other; a lane past the
// last group copies it -- then a thread a (b, round) for L0, so that no
// group's warp waits on it. MIN_BLOCKS: the launch bound's blocks an SM
// (3 shipped, the probe's fastest; 1 leaves the registers to the compiler).
template <bool ALL_ROUNDS, int MIN_BLOCKS>
__global__ void __launch_bounds__(PLONK_THREADS, MIN_BLOCKS) partial_products_kernel(const PartialProductArgs a) {
    const int64_t t = (int64_t)blockIdx.x * PLONK_THREADS + threadIdx.x;
    const int lane_bits = a.lane_bits;
    const int L = 1 << lane_bits, lane = (int)(t & (L - 1));
    const int per_b = ALL_ROUNDS ? a.n_chunks : a.r * a.n_chunks;  // groups a b
    const int64_t groups = a.batch * per_b, chunk_threads = whole_warps(groups << lane_bits);
    if (t >= chunk_threads) {
        if (t - chunk_threads < a.batch * a.r) l0_term(a, t - chunk_threads);
        return;
    }
    int64_t g = t >> lane_bits;
    const bool live = g < groups;
    if (!live) g = groups - 1;  // every lane of a warp takes part in the shuffles
    const unsigned b = (unsigned)g / (unsigned)per_b, rc = (unsigned)g - b * (unsigned)per_b;  // g < 2^31
    const int c = (int)(rc % (unsigned)a.n_chunks), first = ALL_ROUNDS ? 0 : (int)(rc / (unsigned)a.n_chunks);
    const int steps = (a.maxdeg + L - 1) >> lane_bits;  // wires a lane, the last ones past maxdeg for some lanes
    const Ext one = {1, 0}, zeta = gl::at(a.zeta, b);
    const int64_t i0 = (int64_t)c * a.maxdeg;
    for (int round = first; round < (ALL_ROUNDS ? a.r : first + 1); ++round) {
        const uint64_t beta = a.betas[(int64_t)b * a.r + round], gamma = a.gammas[(int64_t)b * a.r + round];
        const Ext bz = gl::escale(beta, zeta);
        Ext num, den;
        wire_terms(a, b, i0 + min(lane, a.maxdeg - 1), beta, gamma, bz, num, den);
        if (lane >= a.maxdeg) num = den = one;  // a select: no branch before the shuffles
        for (int k = 1; k < steps; ++k) {  // the lane's further wires in order (times 1 past maxdeg)
            const int d = lane + (k << lane_bits);
            Ext tn, td;
            wire_terms(a, b, i0 + min(d, a.maxdeg - 1), beta, gamma, bz, tn, td);
            if (d >= a.maxdeg) tn = td = one;
            num = gl::emul_once(num, tn);
            den = gl::emul_once(den, td);
        }
        Ext e;
        if (lane_bits == 0) {
            e = gl::esub(gl::emul_once(current(a, b, round, c), num), gl::emul_once(current(a, b, round, c + 1), den));
        } else {
            const int odd = lane & 1;
            Ext v = gl::emul_once(odd ? den : num, shfl_xor(odd ? num : den, 1, L));  // level 0: a side a lane
            for (int j = 1; j < lane_bits; ++j) v = gl::emul_once(v, shfl_down(v, 1 << j, L));
            v = gl::emul_once(current(a, b, round, c + odd), v);  // lane 0 the numerators' product, lane 1 the denominators'
            e = gl::esub(v, shfl_down(v, 1, L));
        }
        if (live && lane == 0) {
            const int64_t at = (int64_t)b * (a.r + (int64_t)a.r * a.n_chunks) + a.r + (int64_t)round * a.n_chunks + c;
            a.out_re[at] = e.re;
            a.out_im[at] = e.im;
        }
    }
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
    int32_t chunk_bits, re_bits, table_bits;  // lanes a SLDC chunk, the RE transition, a table: 2^bits <= 32
};

// inp + c out, alpha - that (the chunked terms' order in lookup_checks_plain)
__device__ __forceinline__ Ext combo(const LookupArgs& a, int64_t b, int64_t inp, uint64_t c) {
    const Ext x = gl::at(a.wires, b, inp), y = gl::at(a.wires, b, inp + 1);
    return gl::eadd(x, gl::escale(c, y));
}

__device__ __forceinline__ Ext alpha_minus(uint64_t alpha, Ext x) { return gl::esub({alpha, 0}, x); }

// (p, s) o (op, os) = (p op, s op + p os): two leave-one-out pairs of disjoint slots as one
__device__ __forceinline__ void meet(Ext& p, Ext& s, Ext op, Ext os) {
    s = gl::eadd(gl::emul(s, op), gl::emul(p, os));
    p = gl::emul(p, op);
}

struct Round {  // a (b, round) of the grid; live = false for a lane past the region's last, which copies it
    int64_t b, br;  // br = b r + round: the row of deltas and of the output
    int round;
    bool live;
};

__device__ __forceinline__ Round round_of(const LookupArgs& a, int64_t& g, int64_t groups, int per) {
    const bool live = g < groups;
    if (!live) g = groups - 1;  // every lane of a warp takes part in the shuffles
    const unsigned br = (unsigned)g / (unsigned)per, b = br / (unsigned)a.r;  // g < 2^31
    return {b, br, (int)(br - b * a.r), live};
}

__device__ __forceinline__ void put(const LookupArgs& a, int64_t br, int col, Ext e) {
    const int64_t at = br * (4 + a.luts + 2 * (a.n_polys - 1)) + col;
    a.out_re[at] = e.re;
    a.out_im[at] = e.im;
}

// SLDC chunk j of a (b, round): its lanes' pairs, then the two transition equations
__device__ void sldc_lanes(const LookupArgs& a, int64_t t) {
    const int n_sldc = a.n_polys - 1, L = 1 << a.chunk_bits, lane = (int)(t & (L - 1));
    int64_t g = t >> a.chunk_bits;
    const Round rd = round_of(a, g, a.batch * a.r * n_sldc, n_sldc);
    const int j = (int)(g - rd.br * n_sldc);
    const uint64_t* d = a.deltas + rd.br * 4;
    const uint64_t ca = d[0], alpha = d[2];
    const int64_t z0 = (int64_t)rd.round * a.n_polys, b = rd.b;
    const Ext one = {1, 0}, zero = {0, 0};
    Ext lu_p = one, lu_s = zero, lut_p = one, lut_s = zero;
    const int lu_end = min((j + 1) * a.lu_deg, a.num_lu), lut_end = min((j + 1) * a.lut_deg, a.num_lut);
    for (int i = j * a.lu_deg + lane; i < lu_end; i += L) {
        const Ext term = alpha_minus(alpha, combo(a, b, 2 * i, ca));
        lu_s = gl::eadd(gl::emul(lu_s, term), lu_p);
        lu_p = gl::emul(lu_p, term);
    }
    for (int i = j * a.lut_deg + lane; i < lut_end; i += L) {
        const Ext term = alpha_minus(alpha, combo(a, b, 3 * i, ca));
        lut_s = gl::eadd(gl::emul(lut_s, term), gl::emul(gl::at(a.wires, b, 3 * i + 2), lut_p));
        lut_p = gl::emul(lut_p, term);
    }
    for (int k = 0; k < a.chunk_bits; ++k) {  // one value for the whole grid: every lane shuffles alike
        const Ext op = shfl_down(lu_p, 1 << k, L), os = shfl_down(lu_s, 1 << k, L);
        const Ext tp = shfl_down(lut_p, 1 << k, L), ts = shfl_down(lut_s, 1 << k, L);
        meet(lu_p, lu_s, op, os);
        meet(lut_p, lut_s, tp, ts);
    }
    if (rd.live && lane == 0) {
        const Ext prev = j == 0 ? gl::at(a.zs_next, b, z0 + n_sldc) : gl::at(a.zs, b, z0 + j);
        const Ext dmin = gl::esub(gl::at(a.zs, b, z0 + 1 + j), prev);
        put(a, rd.br, 4 + a.luts + 2 * j, gl::emul(gl::at(a.sels, b, 0), gl::esub(gl::emul(lut_p, dmin), lut_s)));
        put(a, rd.br, 5 + a.luts + 2 * j, gl::emul(gl::at(a.sels, b, 1), gl::eadd(gl::emul(lu_p, dmin), lu_s)));
    }
}

// the RE transition of a (b, round) as a segmented Horner sum in delta, and the three single equations
__device__ void re_lanes(const LookupArgs& a, int64_t t) {
    const int S = 1 << a.re_bits, s = (int)(t & (S - 1));
    int64_t g = t >> a.re_bits;
    const Round rd = round_of(a, g, a.batch * a.r, 1);
    const uint64_t* d = a.deltas + rd.br * 4;
    const uint64_t cb = d[1], delta = d[3];
    const int64_t z0 = (int64_t)rd.round * a.n_polys, b = rd.b;
    const int n = a.num_lut, steps = (n + S) >> a.re_bits;  // ceil((n + 1) / S)
    uint64_t q = delta;  // delta^S
    for (int k = 0; k < a.re_bits; ++k) q = gl::mul(q, q);
    Ext acc = {0, 0};
    for (int m = steps - 1; m >= 0; --m) {
        const int k = s + (m << a.re_bits);  // u_k; a first step past u_n adds 0 to 0
        const Ext u = k < n ? combo(a, b, 3 * (n - 1 - k), cb) : k == n ? gl::at(a.zs_next, b, z0) : Ext{0, 0};
        acc = gl::eadd(u, gl::escale(q, acc));
    }
    uint64_t pw = delta;  // delta^(2^k) at level k
    for (int k = 0; k < a.re_bits; ++k) {
        acc = gl::eadd(acc, gl::escale(pw, shfl_down(acc, 1 << k, S)));
        pw = gl::mul(pw, pw);
    }
    if (rd.live && s == 0) {
        const int n_sldc = a.n_polys - 1;
        const Ext re = gl::at(a.zs, b, z0);
        put(a, rd.br, 3 + a.luts, gl::emul(gl::at(a.sels, b, 0), gl::esub(re, acc)));
        put(a, rd.br, 0, gl::emul(gl::at(a.sels, b, 3), gl::at(a.zs, b, z0 + n_sldc)));
        put(a, rd.br, 1, gl::emul(gl::at(a.sels, b, 2), gl::at(a.zs, b, z0 + 1)));
        put(a, rd.br, 2, gl::emul(gl::at(a.sels, b, 2), re));
    }
}

// table k's final RE for a (b, round): its (input, output) columns as segmented Horner sums in delta
__device__ void table_lanes(const LookupArgs& a, int64_t t) {
    const int S = 1 << a.table_bits, s = (int)(t & (S - 1));
    int64_t g = t >> a.table_bits;
    const Round rd = round_of(a, g, a.batch * a.r * a.luts, a.luts);
    const int k = (int)(g - rd.br * a.luts);
    const uint64_t* d = a.deltas + rd.br * 4;
    const uint64_t cb = d[1], delta = d[3];
    const int64_t first = a.table_off[k], rows = a.table_off[k + 1] - first;
    const int64_t steps = (rows + S - 1) >> a.table_bits;
    uint64_t q = delta;
    for (int j = 0; j < a.table_bits; ++j) q = gl::mul(q, q);
    uint64_t acc_in = 0, acc_out = 0;
    for (int64_t m = steps - 1; m >= 0; --m) {
        const int64_t u = s + (m << a.table_bits);  // ascending powers: row first + rows - 1 - u
        const uint64_t* row = u < rows ? a.coeffs + 2 * (first + rows - 1 - u) : nullptr;
        acc_in = gl::add(row ? row[0] : 0, gl::mul(q, acc_in));
        acc_out = gl::add(row ? row[1] : 0, gl::mul(q, acc_out));
    }
    uint64_t pw = delta;
    for (int j = 0; j < a.table_bits; ++j) {
        acc_in = gl::add(acc_in, gl::mul(pw, shfl_down(acc_in, 1 << j, S)));
        acc_out = gl::add(acc_out, gl::mul(pw, shfl_down(acc_out, 1 << j, S)));
        pw = gl::mul(pw, pw);
    }
    if (rd.live && s == 0) {
        const uint64_t expected = gl::add(acc_in, gl::mul(cb, acc_out));
        put(a, rd.br, 3 + k, gl::emul(gl::at(a.sels, rd.b, 4 + k), gl::esub(gl::at(a.zs, rd.b, (int64_t)rd.round * a.n_polys), {expected, 0})));
    }
}

__global__ void __launch_bounds__(PLONK_THREADS) lookup_checks_kernel(const LookupArgs a) {
    const int64_t t = (int64_t)blockIdx.x * PLONK_THREADS + threadIdx.x;
    const int64_t rounds = a.batch * a.r;
    const int64_t sldc = whole_warps((rounds * (a.n_polys - 1)) << a.chunk_bits), re = whole_warps(rounds << a.re_bits);
    if (t < sldc) {
        sldc_lanes(a, t);
    } else if (t < sldc + re) {
        re_lanes(a, t - sldc);
    } else if (t < sldc + re + whole_warps((rounds * a.luts) << a.table_bits)) {
        table_lanes(a, t - sldc - re);
    }
}

// kernels.GateFilterArgs field for field
struct GateFilterArgs {
    ExtView sels;            // (B, n_sel): the gate-selector columns
    ExtView cons;            // (B, live n_gc): live gate k's constraints at columns k n_gc ... (k + 1) n_gc - 1
    const int64_t* cols;     // (live,): live gate k's selector column
    const uint64_t* consts;  // (live, span) contiguous: its factor constants
    const uint8_t* mask;     // (live, span) contiguous bool: its factor slots
    uint64_t* out_re;        // (B, n_gc) contiguous
    uint64_t* out_im;
    int64_t batch;
    int32_t live, n_gc, span, lanes;  // lanes a block
};

constexpr int FILTER_THREADS = 256;

__global__ void __launch_bounds__(FILTER_THREADS) gate_filter_kernel(const GateFilterArgs a) {
    extern __shared__ Ext sel[];  // (lanes, live): the block's lanes' selector values
    const int64_t b0 = (int64_t)blockIdx.x * a.lanes;
    const int lanes = (int)min((int64_t)a.lanes, a.batch - b0);
    for (int i = threadIdx.x; i < lanes * a.live; i += FILTER_THREADS) {
        const int l = i / a.live, k = i - l * a.live;
        const Ext x = gl::at(a.sels, b0 + l, a.cols[k]);
        Ext s = {1, 0};
        bool first = true;
        for (int j = 0; j < a.span; ++j) {
            if (!a.mask[k * a.span + j]) continue;
            const Ext t = gl::esub({a.consts[k * a.span + j], 0}, x);
            s = first ? t : gl::emul(s, t);
            first = false;
        }
        sel[i] = s;
    }
    __syncthreads();
    const gl::Wide zero = {0, 0, 0};
    for (int i = threadIdx.x; i < lanes * a.n_gc; i += FILTER_THREADS) {
        const int l = i / a.n_gc, c = i - l * a.n_gc;
        const int64_t b = b0 + l;
        gl::Wide rr = zero, ii = zero, im = zero;
        for (int k = 0; k < a.live; ++k) {
            const Ext s = sel[l * a.live + k], v = gl::at(a.cons, b, (int64_t)k * a.n_gc + c);
            rr = gl::wide_add(rr, gl::wide_mul(s.re, v.re));
            ii = gl::wide_add(ii, gl::wide_mul(s.im, v.im));
            im = gl::wide_add(gl::wide_add(im, gl::wide_mul(s.re, v.im)), gl::wide_mul(s.im, v.re));
        }
        a.out_re[b * a.n_gc + c] = gl::reduce192(gl::wide_add(rr, gl::wide_times7(ii)));
        a.out_im[b * a.n_gc + c] = gl::reduce192(im);
    }
}

unsigned blocks_for(int64_t threads) { return (unsigned)((threads + PLONK_THREADS - 1) / PLONK_THREADS); }

template <bool ALL_ROUNDS, int MIN_BLOCKS>
cudaError_t launch_partial_products(const PartialProductArgs& a, cudaStream_t stream) {
    const int lane_bits = a.lane_bits;
    if (a.batch < 0 || a.r < 0 || a.maxdeg < 1 || a.n_chunks < 1 || a.npp != a.n_chunks - 1 || lane_bits < 0 || lane_bits > 5)
        return cudaErrorInvalidValue;
    const int64_t groups = a.batch * (ALL_ROUNDS ? 1 : a.r) * a.n_chunks;
    if (a.r > INT32_MAX / a.n_chunks || groups >= (INT32_MAX >> lane_bits) - 32 || a.batch * a.r >= INT32_MAX / 2)
        return cudaErrorInvalidValue;
    const int64_t threads = whole_warps(groups << lane_bits) + a.batch * a.r;
    if (threads > 0 && a.r > 0)
        partial_products_kernel<ALL_ROUNDS, MIN_BLOCKS><<<blocks_for(threads), PLONK_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" int p2v_partial_products(const void* args, void* stream) {
    return (int)launch_partial_products<false, 3>(*(const PartialProductArgs*)args, (cudaStream_t)stream);
}

#ifdef P2V_PP_VARIANTS
// the probe tool's forms (tools/probe_kernels.py --pp-lanes): a group a
// (b, round, chunk) or with all_rounds a (b, chunk), under a launch bound
// of min_blocks blocks an SM (1, 3 or 4)
extern "C" int p2v_partial_products_variant(const void* args, int all_rounds, int min_blocks, void* stream) {
    const PartialProductArgs& a = *(const PartialProductArgs*)args;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (min_blocks * 2 + (all_rounds != 0)) {
        case 2: return (int)launch_partial_products<false, 1>(a, s);
        case 3: return (int)launch_partial_products<true, 1>(a, s);
        case 6: return (int)launch_partial_products<false, 3>(a, s);
        case 7: return (int)launch_partial_products<true, 3>(a, s);
        case 8: return (int)launch_partial_products<false, 4>(a, s);
        case 9: return (int)launch_partial_products<true, 4>(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
#endif

extern "C" int p2v_lookup_checks(const void* args, void* stream) {
    const LookupArgs a = *(const LookupArgs*)args;
    if (a.batch < 0 || a.r < 0 || a.luts < 0 || a.n_polys < 2 || a.num_lu < 0 || a.num_lut < 1 || a.lu_deg < 1 || a.lut_deg < 1)
        return (int)cudaErrorInvalidValue;
    if (a.chunk_bits < 0 || a.chunk_bits > 5 || a.re_bits < 0 || a.re_bits > 5 || a.table_bits < 0 || a.table_bits > 5)
        return (int)cudaErrorInvalidValue;  // a group of lanes within a warp
    const int64_t rounds = a.batch * a.r;
    if (rounds >= INT32_MAX / 32 || a.n_polys > 1024 || a.luts > 1024) return (int)cudaErrorInvalidValue;
    const int64_t threads = whole_warps((rounds * (a.n_polys - 1)) << a.chunk_bits) + whole_warps(rounds << a.re_bits) +
                            whole_warps((rounds * a.luts) << a.table_bits);
    if (threads >= INT32_MAX) return (int)cudaErrorInvalidValue;
    if (threads > 0) lookup_checks_kernel<<<blocks_for(threads), PLONK_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int p2v_gate_filter(const void* args, void* stream) {
    const GateFilterArgs a = *(const GateFilterArgs*)args;
    // kernels.GATE_FILTER_MAX_LIVE and _MAX_SPAN: the selector values fit the default 48 KB of shared memory, the sums' top word 2^32
    if (a.batch < 0 || a.live < 1 || a.live > 3072 || a.n_gc < 1 || a.span < 1 || a.span > 64 || a.lanes < 1 || a.lanes > 32)
        return (int)cudaErrorInvalidValue;
    const size_t shared = sizeof(Ext) * (size_t)a.lanes * a.live;
    const int64_t blocks = (a.batch + a.lanes - 1) / a.lanes;
    if (shared > 48 * 1024 || (int64_t)a.lanes * a.n_gc >= INT32_MAX || blocks >= INT32_MAX) return (int)cudaErrorInvalidValue;
    if (blocks > 0) gate_filter_kernel<<<(unsigned)blocks, FILTER_THREADS, shared, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
