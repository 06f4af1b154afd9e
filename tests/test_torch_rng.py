"""Counter RNG of the port (ops/cuda_mh.py) against odelib_tpu's _mix/_Rng:
the uint32 words bitwise, the uniforms exactly, the normals to 1 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.ops import pallas_mh as J
from odelib_tpu_torch.ops import cuda_mh as T

_TILE, _SHAPE = 1024, (8, 128)


def test_mix_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]])
    x = x.astype(np.uint32)
    ref = np.asarray(J._mix(jnp.asarray(x)))
    got = T.mix(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def _jax_tiles(seed, n_tiles):
    return [J._Rng(_SHAPE, jnp.int32(seed), jnp.int32(pid), _TILE)
            for pid in range(n_tiles)]


# it near 2**22: it * 1024 wraps the 32-bit counter
@pytest.mark.parametrize("seed,it", [(0, 1), (7, 13), (-3, 2 ** 22 - 1),
                                     (12345, 2 ** 22), (2 ** 31 - 1,
                                                        2 ** 22 + 5)])
def test_rng_words_bitwise(seed, it):
    """Several tiles' worth of chains: the port keys on the global chain
    index, the JAX kernel on program id * tile + lane."""
    n_tiles = 3
    ref = np.concatenate([
        np.stack([np.asarray(r.bits(jnp.int32(it))).ravel()
                  for _ in range(5)])
        for r in _jax_tiles(seed, n_tiles)], axis=1)
    rng = T.Rng(seed, torch.arange(n_tiles * _TILE))
    rng.start(it)
    got = np.stack([rng.bits().numpy() for _ in range(5)])
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


@pytest.mark.parametrize("seed,it", [(0, 1), (99, 500), (-8, 2 ** 22 + 1)])
def test_uniform_and_normal(seed, it):
    """Uniforms (integer-exact) bitwise; Box-Muller normals within one ulp
    of each factor, r = sqrt(-2 log u1) and c = cos(2 pi u2) (the two
    libraries round log/sqrt/cos independently, and near a zero of the
    cosine one ulp of c is many ulps of the product)."""
    ref_u, ref_n = [], []
    for r in _jax_tiles(seed, 2):
        ref_u.append(np.asarray(r.uniform(jnp.int32(it))).ravel())
        ref_n.append(np.asarray(r.normal(jnp.int32(it))).ravel())
    ref_u, ref_n = np.concatenate(ref_u), np.concatenate(ref_n)
    rng = T.Rng(seed, torch.arange(2 * _TILE))
    rng.start(it)
    u = rng.uniform().numpy()
    n = rng.normal().numpy()
    assert u.dtype == n.dtype == np.float32
    np.testing.assert_array_equal(u, ref_u)
    assert ((u > 0) & (u < 1)).all()
    u1, u2 = (rng_uniforms(seed, it, 2 * _TILE)[k] for k in (1, 2))
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
    c = np.cos(2.0 * np.pi * u2.astype(np.float64))
    sp = lambda v: np.spacing(np.abs(v).astype(np.float32)).astype(float)
    tol = sp(r) * np.abs(c) + r * sp(c) + sp(ref_n)
    assert (np.abs(n.astype(float) - ref_n) <= tol).all()
    assert np.mean(n == ref_n) > 0.5


def rng_uniforms(seed, it, n_chains):
    """The port's first three uniforms of iteration ``it``."""
    rng = T.Rng(seed, torch.arange(n_chains))
    rng.start(it)
    return [rng.uniform().numpy() for _ in range(3)]


def test_rng_slot_budget_guard():
    rng = T.Rng(0, torch.arange(4))
    rng.start(1)
    for _ in range(1024):
        rng.bits()
    with pytest.raises(ValueError, match="slot budget"):
        rng.bits()
