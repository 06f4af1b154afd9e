"""The port's ``jax.random`` stream (odelib_tpu_torch/random.py) against
jax.random itself under the JAX package's test settings (x64, threefry
partitionable): keys, fold-ins, splits, bits, uniforms and randints
bitwise over several seeds and shapes, float64 normals within 2 ulps
(measured 0), permutations bitwise (tied sort words included), batched
keys as a vmap over keys; exponentials within 1 ulp, gammas bitwise from
a = 1 (2 ulps below: the boost's ``pow``), Student-t within 2 ulps and
Poisson counts equal up to a rate of 300."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu_torch import random as R

SEEDS = [0, 1, 42, 2 ** 31 - 1, -3, 2 ** 40 + 7]
SHAPES = [(), (5,), (3, 4), (2, 3, 5)]


def _words(k):
    return np.asarray(k).astype(np.int64)


def test_partitionable_threefry_is_the_setting_ported():
    """The port implements threefry2x32 with the partitionable key
    derivation; a jax with another default must fail here loudly."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_enable_x64 is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_bitwise(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    np.testing.assert_array_equal(t.numpy(), _words(k))
    for data in (0, 1, 12345, 2 ** 32 - 1, 2 ** 33 + 5, -7):
        np.testing.assert_array_equal(
            R.fold_in(t, data).numpy(),
            _words(jax.random.fold_in(k, jnp.asarray(data).astype(
                jnp.uint32))))
    for num in (2, 3, 4, 7):
        np.testing.assert_array_equal(R.split(t, num).numpy(),
                                      _words(jax.random.split(k, num)))
    # a batch of keys is a vmap over keys
    ks = jax.random.split(k, 6)
    np.testing.assert_array_equal(
        R.fold_in(R.split(t, 6), torch.arange(6)).numpy(),
        _words(jax.vmap(jax.random.fold_in)(ks, jnp.arange(6))))
    np.testing.assert_array_equal(
        R.split(R.split(t, 6), 3).numpy(),
        _words(jax.vmap(lambda kk: jax.random.split(kk, 3))(ks)))
    data = R.key_data(R.split(t, 6))
    np.testing.assert_array_equal(data, np.asarray(jax.random.key_data(ks)))
    np.testing.assert_array_equal(R.wrap_key_data(data).numpy(), _words(ks))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniforms_bitwise(seed, shape):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    np.testing.assert_array_equal(
        R.bits(t, shape).numpy(),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
    for dt, tdt in ((jnp.float64, torch.float64),
                    (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            R.uniform(t, shape, tdt).numpy(),
            np.asarray(jax.random.uniform(k, shape, dt)))
        np.testing.assert_array_equal(
            R.uniform(t, shape, tdt, -2.5, 7.0).numpy(),
            np.asarray(jax.random.uniform(k, shape, dt, -2.5, 7.0)))
    ks = jax.random.split(k, 5)
    np.testing.assert_array_equal(
        R.uniform(R.split(t, 5), shape).numpy(),
        np.asarray(jax.vmap(lambda kk: jax.random.uniform(
            kk, shape, jnp.float64))(ks)))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    for dt, tdt in ((jnp.int64, torch.int64), (jnp.int32, torch.int32)):
        for lo, hi in ((0, 2), (0, 3), (0, 16), (-5, 995), (0, 2 ** 20 + 3),
                       (7, 7)):
            got = R.randint(t, (4, 25), lo, hi, tdt)
            assert got.dtype == tdt
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax.random.randint(
                    k, (4, 25), lo, hi, dt)))
    # the ensemble's partner draw: int (int64 under x64), a batch of keys
    ks = jax.random.split(k, 4)
    np.testing.assert_array_equal(
        R.randint(R.split(t, 4), (6,), 0, 6).numpy(),
        np.asarray(jax.vmap(lambda kk: jax.random.randint(kk, (6,), 0, 6))(
            ks)))


def _ulps(got, ref):
    ref = np.asarray(ref)
    return np.abs(got - ref) / np.spacing(np.abs(ref).astype(ref.dtype))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_two_ulps(seed):
    """float64, the samplers' dtype (float32 normals differ a little more:
    XLA computes their log1p's logarithm by a polynomial of its own)."""
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    got = R.normal(t, (4000,), torch.float64).numpy()
    ref = np.asarray(jax.random.normal(k, (4000,), jnp.float64))
    assert _ulps(got, ref).max() <= 2.0
    ks = jax.random.split(k, 8)
    got = R.normal(R.split(t, 8), (3,)).numpy()
    ref = jax.vmap(lambda kk: jax.random.normal(kk, (3,), jnp.float64))(ks)
    assert _ulps(got, ref).max() <= 2.0


def test_erfinv_and_log1p_edges():
    """The +-1 ends, zero and the region boundaries of XLA's polynomials;
    a NaN stays NaN."""
    x = torch.tensor([-1.0, -0.999999, -0.5, 0.0, 1e-300, 0.41421356,
                      0.9, 0.99999999999, 1.0, float("nan")],
                     dtype=torch.float64)
    got = R.erfinv(x).numpy()
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(ref)
    assert np.isinf(got[~ok & ~np.isnan(ref)]).all()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-15)
    y = torch.tensor([-0.5, -0.4142, -1e-8, 0.0, 1e-8, 0.4142, 3.0],
                     dtype=torch.float64)
    np.testing.assert_allclose(
        R.log1p(y).numpy(), np.asarray(jax.lax.log1p(jnp.asarray(
            y.numpy()))), rtol=1e-15)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000, 10000])
def test_permutation_bitwise(n):
    """``jax.random.permutation(key, n)`` (HMC's warmup-boundary
    rejuvenation): one round of stable sorts by 32-bit words up to 1,625
    elements, two at 10,000, where equal words keep their order; over
    several keys, and a batch of keys as a vmap."""
    for seed in SEEDS[:4]:
        k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
        np.testing.assert_array_equal(
            R.permutation(t, n).numpy(),
            np.asarray(jax.random.permutation(k, n)))
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    np.testing.assert_array_equal(
        R.permutation(R.split(R.PRNGKey(5), 3), n).numpy(),
        np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, n))(ks)))


@pytest.mark.parametrize("seed", [98, 148])
def test_permutation_keeps_tied_words_in_order(seed):
    """Equal sort words keep their positions' order (jax's stable
    ``sort_key_val``): under PRNGKey(98) and PRNGKey(148) two of the first
    round's 10,000 words are equal (the first two such keys of 0..199)."""
    n = 10000
    words = R.bits(R.split(R.PRNGKey(seed))[1], (n,))
    assert len(torch.unique(words)) == n - 1
    np.testing.assert_array_equal(
        R.permutation(R.PRNGKey(seed), n).numpy(),
        np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_exponential_within_one_ulp(seed):
    """``-log1p(-u)`` with XLA's log1p: 0 ulps but where the two
    libraries' ``log`` round apart (1 ulp, seen under PRNGKey(42))."""
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    got = R.exponential(t, (3000,)).numpy()
    ref = np.asarray(jax.random.exponential(k, (3000,), jnp.float64))
    assert _ulps(got, ref).max() <= 1.0


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("a", [0.3, 1.0, 2.5, 7.0])
def test_gamma_bitwise_from_one_and_within_two_ulps_below(seed, a):
    """Marsaglia-Tsang on jax's keys, both rejection loops masked over the
    batch: bitwise for a >= 1; below 1 the boost's ``pow`` of two
    libraries parts them by up to 2 ulps. A batch of keys with per-key
    shapes is a vmap."""
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    got = R.gamma(t, a, (1500,)).numpy()
    ref = np.asarray(jax.random.gamma(k, a, (1500,), jnp.float64))
    tol = 0.0 if a >= 1.0 else 2.0
    assert _ulps(got, ref).max() <= tol
    ks = jax.random.split(k, 4)
    alphas = np.array([a, a + 0.5, 3.0, 11.0])
    ref = np.asarray(jax.vmap(lambda kk, aa: jax.random.gamma(
        kk, aa, (5,), jnp.float64))(ks, alphas))
    got = R.gamma(R.split(t, 4), torch.as_tensor(alphas)[:, None],
                  (5,)).numpy()
    assert _ulps(got, ref).max() <= tol


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("df", [1.5, 4.0, 30.0])
def test_t_within_two_ulps(seed, df):
    """A normal times sqrt(df / 2 / gamma(df / 2)), each from its split of
    the key: within the normal's 2 ulps (and the gamma's below 1)."""
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    got = R.t(t, df, (2000,)).numpy()
    ref = np.asarray(jax.random.t(k, df, (2000,), jnp.float64))
    assert _ulps(got, ref).max() <= 2.0
    ref = np.asarray(jax.vmap(lambda kk: jax.random.t(
        kk, df, (3, 2), jnp.float64))(jax.random.split(k, 5)))
    assert _ulps(R.t(R.split(t, 5), df, (3, 2)).numpy(), ref).max() <= 2.0


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_poisson_counts_equal(seed):
    """Knuth below a rate of 10 (float32 logs) and the float32 transformed
    rejection from 10 up to 300, jax's placeholders in the rounds, 0 at a
    zero rate and -1 at NaN (jax's result): equal counts, for one key over
    mixed rates and a batch of keys as a vmap. Above a rate of ~10^3 the
    two libraries' float32 ``lgamma`` and ``log`` part a few draws (ROADMAP
    queue 3)."""
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    for lam in (0.5, 3.0, 9.99, 10.0, 60.0, 300.0):
        got = R.poisson(t, lam, (2000,)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.poisson(k, lam, (2000,))))
        assert got.dtype == np.int64
    lam = np.random.default_rng(seed).uniform(0.0, 40.0, (6, 25))
    lam[0, :3] = (0.0, np.nan, 10.0)
    ks = jax.random.split(k, 6)
    ref = np.asarray(jax.vmap(lambda kk, ll: jax.random.poisson(
        kk, ll, (25,)))(ks, lam))
    got = R.poisson(R.split(t, 6), torch.as_tensor(lam), (25,)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 0 and got[0, 1] == -1
