"""Port field ops (plonky2_verifier_tpu_torch.ops.field) against the JAX
field (plonky2_verifier_tpu.ops.field) and the golden model.

Inputs are random values plus the p-edge band, made with numpy from a seed
and fed to both; the exponentiations also on words x + p (proof words need
not be canonical), at e = 0, 1, 2 and random, where the two plain functions'
conventions differ (pow_dynamic multiplies from 1, ext_pow_const returns
the input's own bits at e = 1). The port's inversion and exponentiations
are its plain versions (`inv_plain`, `pow_dynamic_plain`,
`ext_pow_const_plain`), held against the JAX package's `inv`, `pow_dynamic`
and `ext_pow_const`. Tolerance: bit-exact (integer arithmetic)."""

import numpy as np
import pytest

from plonky2_verifier_tpu.golden import field as gf
from plonky2_verifier_tpu.ops import field as jf
from plonky2_verifier_tpu_torch.ops import field as tf
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

P = gf.P
EDGE = np.array([0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**32 + 1, 2**63, P - 2**32], dtype=np.uint64)


def _values(seed: int, n: int = 512) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, P, size=n, dtype=np.uint64)
    return np.concatenate([rand, np.repeat(EDGE, len(EDGE)), np.tile(EDGE, len(EDGE))])


@pytest.fixture(scope="module")
def ab():
    return _values(1), _values(2)[::-1].copy()


def _jax(fn, *xs):
    return jf.to_u64(fn(*[jf.from_u64(x) for x in xs]))


def _torch(fn, *xs):
    return tf.to_u64(fn(*[tf.from_u64(x, "cpu") for x in xs]))


BINARY = [
    ("add", tf.add, jf.add, gf.fadd),
    ("sub", tf.sub, jf.sub, gf.fsub),
    ("mul", tf.mul, jf.mul, gf.fmul),
]


@pytest.mark.parametrize("name,t_op,j_op,g_op", BINARY, ids=[b[0] for b in BINARY])
def test_binary_ops(ab, name, t_op, j_op, g_op):
    a, b = ab
    got = _torch(t_op, a, b)
    np.testing.assert_array_equal(got, _jax(j_op, a, b))
    assert [int(x) for x in got] == [g_op(int(x), int(y)) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", ["neg", "square", "inv"])
def test_unary_ops(ab, name):
    a, _ = ab
    got = _torch(tf.inv_plain if name == "inv" else getattr(tf, name), a)
    np.testing.assert_array_equal(got, _jax(getattr(jf, name), a))
    golden = {"neg": gf.fneg, "square": lambda x: gf.fmul(x, x), "inv": lambda x: gf.finv(x) if x else 0}[name]
    assert [int(x) for x in got] == [golden(int(x)) for x in a]


def test_inv_zero_is_zero():
    assert int(_torch(tf.inv_plain, np.zeros(1, dtype=np.uint64))[0]) == 0


@pytest.mark.parametrize("e", [0, 1, 7, 4096, P - 2])
def test_pow_const(ab, e):
    a, _ = ab
    got = _torch(lambda x: tf.pow_const(x, e), a)
    np.testing.assert_array_equal(got, _jax(lambda x: jf.pow_const(x, e), a))
    assert [int(x) for x in got] == [pow(int(x), e, P) for x in a]


def test_pow_dynamic(ab):
    a, _ = ab
    exps = np.random.default_rng(3).integers(0, 1 << 15, size=a.shape, dtype=np.uint64)
    got = tf.to_u64(tf.pow_dynamic_plain(tf.from_u64(a, "cpu"), tf.from_u64(exps, "cpu"), 15))
    want = jf.to_u64(jf.pow_dynamic(jf.from_u64(a), jf.from_u64(exps).lo, 15))
    np.testing.assert_array_equal(got, want)
    assert [int(x) for x in got] == [pow(int(x), int(e), P) for x, e in zip(a, exps)]


def _ext_pair(seed):
    return _values(seed), _values(seed + 10)


def _t_ext(re, im):
    return tf.GExt(tf.from_u64(re, "cpu"), tf.from_u64(im, "cpu"))


def _j_ext(re, im):
    return jf.GExt(jf.from_u64(re), jf.from_u64(im))


def _check_ext(t_out, j_out, golden):
    t_re, t_im = tf.to_u64(t_out.re), tf.to_u64(t_out.im)
    np.testing.assert_array_equal(t_re, jf.to_u64(j_out.re))
    np.testing.assert_array_equal(t_im, jf.to_u64(j_out.im))
    assert list(zip((int(x) for x in t_re), (int(x) for x in t_im))) == golden


def test_emul():
    (ar, ai), (br, bi) = _ext_pair(4), _ext_pair(5)
    golden = [gf.emul((int(a), int(b)), (int(c), int(d))) for a, b, c, d in zip(ar, ai, br, bi)]
    _check_ext(tf.emul(_t_ext(ar, ai), _t_ext(br, bi)), jf.emul(_j_ext(ar, ai), _j_ext(br, bi)), golden)


def test_ext_inv_and_div():
    (ar, ai), (br, bi) = _ext_pair(6), _ext_pair(7)
    nz = (br != 0) | (bi != 0)
    golden = [gf.einv((int(c), int(d))) if (c or d) else (0, 0) for c, d in zip(br, bi)]
    _check_ext(tf.ext_inv(_t_ext(br, bi)), jf.ext_inv(_j_ext(br, bi)), golden)
    ar, ai, br, bi = ar[nz], ai[nz], br[nz], bi[nz]
    golden = [gf.ediv((int(a), int(b)), (int(c), int(d))) for a, b, c, d in zip(ar, ai, br, bi)]
    _check_ext(tf.ext_div(_t_ext(ar, ai), _t_ext(br, bi)), jf.ext_div(_j_ext(ar, ai), _j_ext(br, bi)), golden)


@pytest.mark.parametrize("e", [0, 1, 5, 4096])
def test_ext_pow_const(e):
    ar, ai = _ext_pair(8)
    golden = [gf.epow((int(a), int(b)), e) for a, b in zip(ar, ai)]
    _check_ext(tf.ext_pow_const_plain(_t_ext(ar, ai), e), jf.ext_pow_const(_j_ext(ar, ai), e), golden)


def test_ext_equal_and_where():
    ar, ai = _ext_pair(9)
    br, bi = ar.copy(), ai.copy()
    br[::3] ^= np.uint64(1)
    bi[1::5] ^= np.uint64(2)
    eq = tf.ext_equal(_t_ext(ar, ai), _t_ext(br, bi)).numpy()
    np.testing.assert_array_equal(eq, np.asarray(jf.ext_equal(_j_ext(ar, ai), _j_ext(br, bi))))
    mask = np.arange(len(ar)) % 2 == 0
    import torch

    got = tf.ext_where(torch.from_numpy(mask), _t_ext(ar, ai), _t_ext(br, bi))
    want = jf.ext_where(mask, _j_ext(ar, ai), _j_ext(br, bi))
    np.testing.assert_array_equal(tf.to_u64(got.re), jf.to_u64(want.re))
    np.testing.assert_array_equal(tf.to_u64(got.im), jf.to_u64(want.im))


def test_u64_round_trip_and_unsigned_compare():
    a = _values(11)
    np.testing.assert_array_equal(tf.to_u64(tf.from_u64(a, "cpu")), a)
    b = a[::-1].copy()
    np.testing.assert_array_equal(tf.ult(tf.from_u64(a, "cpu"), tf.from_u64(b, "cpu")).numpy(), a < b)
    np.testing.assert_array_equal(tf.to_u64(tf.shr(tf.from_u64(a, "cpu"), 13)), a >> np.uint64(13))


def _noncanonical(seed: int, n: int = 256) -> np.ndarray:
    """The edge band and words x + p (x < 2^32 - 1), shuffled."""
    rng = np.random.default_rng(seed)
    w = np.concatenate([EDGE, rng.integers(0, 2**32 - 1, size=n, dtype=np.uint64) + np.uint64(P)])
    rng.shuffle(w)
    return w


@pytest.mark.parametrize("e", ["0", "1", "2", "random"])
def test_pow_dynamic_on_noncanonical_bases(e):
    a = _noncanonical(20)
    exps = np.full(a.shape, int(e), dtype=np.uint64) if e != "random" else np.random.default_rng(21).integers(0, 1 << 15, size=a.shape, dtype=np.uint64)
    got = tf.to_u64(tf.pow_dynamic_plain(tf.from_u64(a, "cpu"), tf.from_u64(exps, "cpu"), 15))
    np.testing.assert_array_equal(got, jf.to_u64(jf.pow_dynamic(jf.from_u64(a), jf.from_u64(exps).lo, 15)))
    assert [int(x) for x in got] == [pow(int(x), int(k), P) for x, k in zip(a, exps)]  # canonical, 1 at e = 0


@pytest.mark.parametrize("e", [0, 1, 2, 3, 4096, 0x9E3779B97F4A7C15])
def test_ext_pow_const_on_noncanonical_bases(e):
    ar, ai = _noncanonical(22), _noncanonical(23)
    got = tf.ext_pow_const_plain(_t_ext(ar, ai), e)
    want = jf.ext_pow_const(_j_ext(ar, ai), e)
    np.testing.assert_array_equal(tf.to_u64(got.re), jf.to_u64(want.re))
    np.testing.assert_array_equal(tf.to_u64(got.im), jf.to_u64(want.im))
    if e == 1:  # the input's own bits
        np.testing.assert_array_equal(tf.to_u64(got.re), ar)
    golden = [gf.epow((int(a), int(b)), e) for a, b in zip(ar, ai)]
    assert [(int(x) % P, int(y) % P) for x, y in zip(tf.to_u64(got.re), tf.to_u64(got.im))] == golden


# -- the grouped forms the verifier's forward calls once each ------------------
# (ops/field.pow_grouped, inv_grouped; on the CPU their plain versions, beside
# the kernels' own order in PyTorch from tools/check_field_kernels.py)

import torch  # noqa: E402

from plonky2_verifier_tpu.verifier_jax import _bit_reverse as j_bit_reverse  # noqa: E402
from plonky2_verifier_tpu_torch.kernels import INV_GROUP  # noqa: E402
from plonky2_verifier_tpu_torch.tools.check_field_kernels import (  # noqa: E402
    inv_grouped_split_plain,
    pow_grouped_cases,
    pow_grouped_rows_plain,
)

GEN_CASES = pow_grouped_cases("cpu")  # query points (15 bits), two fold steps, a final x of 0 bits, factor 1 and a shift


def _query_indices(seed, rows=16, q=28):
    idx = np.random.default_rng(seed).integers(0, 1 << 15, size=(rows, q), dtype=np.int64)
    idx[0, :4] = [0, (1 << 15) - 1, 1, 1 << 14]  # exponents 0 and all bits set among them
    return idx


def _jax_generator_power(g, idx):
    """The JAX call site's form: factor * pow_dynamic(g, bit_reverse(...), max(bits, 1))."""
    import jax.numpy as jnp

    shape = idx.shape
    e = j_bit_reverse((jnp.asarray(idx) >> (g.shift + g.clear)) << g.clear, g.bits)
    power = jf.pow_dynamic(jf.constant(g.generator, shape), e.astype(jnp.uint32), max(g.bits, 1))
    return jf.to_u64(jf.mul(jf.constant(g.factor, shape), power))


@pytest.mark.parametrize("k", range(len(GEN_CASES)), ids=[f"g{g.bits}b-shift{g.shift}-clear{g.clear}-f{'1' if g.factor == 1 else 'x'}" for g in GEN_CASES])
@pytest.mark.parametrize("view", ["whole", "strided"])
def test_pow_grouped_generator_segments_against_the_jax_call_sites(k, view):
    g = GEN_CASES[k]
    idx_np = _query_indices(30 + k)
    idx = torch.from_numpy(idx_np)
    if view == "strided":  # a mesh rank's query slice: row stride 28, 14 columns
        idx, idx_np = idx[:, 7:21], idx_np[:, 7:21]
    (got,), _ = tf.pow_grouped(idx, [g], [])
    want = _jax_generator_power(g, idx_np)
    np.testing.assert_array_equal(tf.to_u64(got), want)
    (split,), _ = pow_grouped_rows_plain(idx, [(g.table, g.shift, g.clear, g.factor)], [])  # the table products
    np.testing.assert_array_equal(tf.to_u64(split).reshape(want.shape), want)
    e = gf.reverse_bits(g.bits, (int(idx_np[0, 0]) >> (g.shift + g.clear)) << g.clear) if g.bits else 0
    assert int(tf.to_u64(got)[0, 0]) == gf.fmul(g.factor, gf.fpow(g.generator, e))


@pytest.mark.parametrize("e", [0, 1, 2, 3, 4096, 2**64 - 1, 0x9E3779B97F4A7C15])
def test_pow_grouped_extension_segments_against_ext_pow_const(e):
    ar, ai = _noncanonical(40), _noncanonical(41)
    idx = torch.from_numpy(_query_indices(42))
    gens, exts = tf.pow_grouped(idx, GEN_CASES[:1], [(_t_ext(ar, ai), e), (_t_ext(ai, ar), 5)])
    want = jf.ext_pow_const(_j_ext(ar, ai), e)
    np.testing.assert_array_equal(tf.to_u64(exts[0].re), jf.to_u64(want.re))
    np.testing.assert_array_equal(tf.to_u64(exts[0].im), jf.to_u64(want.im))
    want5 = jf.ext_pow_const(_j_ext(ai, ar), 5)
    np.testing.assert_array_equal(tf.to_u64(exts[1].re), jf.to_u64(want5.re))
    np.testing.assert_array_equal(tf.to_u64(gens[0]), _jax_generator_power(GEN_CASES[0], idx.numpy()))
    if e >= 2:  # what the launch computes on its arguments (0 and 1 never reach it)
        _, ((re, im),) = pow_grouped_rows_plain(None, [], [(tf.from_u64(ar, "cpu"), tf.from_u64(ai, "cpu"), e)])
        np.testing.assert_array_equal(tf.to_u64(re), jf.to_u64(want.re))
        np.testing.assert_array_equal(tf.to_u64(im), jf.to_u64(want.im))


def _grouped_words(n: int, seed: int) -> np.ndarray:
    """n words (random, the band, x + p) with a zero in every position of
    the first group and a p in every position of the last."""
    rng = np.random.default_rng(seed)
    w = np.concatenate([rng.integers(0, P, size=n, dtype=np.uint64), _noncanonical(seed, n)])[rng.permutation(2 * n)][:n]
    groups = -(-n // INV_GROUP)
    for j in range(INV_GROUP):
        if j * groups < n:
            w[j * groups] = 0
        if groups > 1 and groups - 1 + j * groups < n:
            w[groups - 1 + j * groups] = P
    return w


@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 9, 17, 64, 1001])
def test_inv_grouped_against_jax_inv(n):
    w = _grouped_words(n, 50 + n)
    a = tf.from_u64(w, "cpu")
    (got,) = tf.inv_grouped([a])
    assert got.shape == (n,)
    if n:
        want = _jax(jf.inv, w)
        np.testing.assert_array_equal(tf.to_u64(got), want)
        np.testing.assert_array_equal(tf.to_u64(inv_grouped_split_plain(a)), want)  # the kernel's order
        assert [int(x) for x in want] == [gf.finv(int(x) % P) if int(x) % P else 0 for x in w]


def test_inv_grouped_keeps_each_part_and_its_shape():
    parts_np = [_grouped_words(3, 60), _grouped_words(10, 61).reshape(2, 5), np.zeros(0, np.uint64), _grouped_words(28 * 4, 62).reshape(4, 28)]
    got = tf.inv_grouped([tf.from_u64(p, "cpu") for p in parts_np])
    for g, p in zip(got, parts_np):
        assert tuple(g.shape) == p.shape
        if p.size:
            np.testing.assert_array_equal(tf.to_u64(g).reshape(-1), _jax(jf.inv, p.reshape(-1)))
    flat = torch.cat([tf.from_u64(p.reshape(-1), "cpu") for p in parts_np])
    np.testing.assert_array_equal(tf.to_u64(inv_grouped_split_plain(flat)), tf.to_u64(torch.cat([g.reshape(-1) for g in got])))
