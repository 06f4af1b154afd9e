"""``step_kvaerno3``'s quotient (ops/build.py ``KV3_QUOTIENT``) against
IEEE float32 division, and the generated step's divisions.

The kernel divides without an IEEE division: once a step each divisor d is
split as d = ds 2^k (|ds| in [1, 2)), with rs = (1/d) 2^k and sc = 2^-k;
a quotient is q0 = x rs, e = fma(-ds, q0, x), q1 = fma(e, rs, q0),
q = q1 sc, and q0 sc stands for q1 sc where x is +-0, +-inf or NaN. A
divisor with |d| outside [2^-125, 2^126) (NaN excepted), a finite
non-zero |x| below 2^-102 or a subnormal quotient sets the step's flag,
and the step is taken again with IEEE divisions. Here that sequence runs
in exact rational arithmetic (``fractions.Fraction``, each operation
rounded once to float32), and a vectorized twin (float64 products, which
are exact, and a TwoSum for the last FMA) runs it on every operand pair
the torch twin's Kvaerno3 steps divide. Both are held bitwise against
numpy's float32 division, which is IEEE's, wherever the flag stays down.
The card test of the compiled function is
``tests/test_torch_cuda.py::test_kv3_quotient_matches_fdiv_rn``. This file
imports neither jax nor the JAX package.
"""
import re
from fractions import Fraction

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from odelib_tpu_torch.model import rhs_program
from odelib_tpu_torch.models import chemistry, zero_i
from odelib_tpu_torch.ops import build
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops.runge_kutta import KV3_NEWTON, kvaerno3_fixed_step

from test_torch_mh_prefetch import demo_inputs

F32 = np.float32
U32 = np.uint32
TINY = F32(2.0 ** -102)     # kv3_quotient: smaller dividends raise the flag


def test_constants_and_sequence_are_the_kernels():
    """The emulation's constants and sequence are the ones the kernel
    source compiles."""
    src = build.KV3_QUOTIENT
    for text in ("bad |= eb - 2u > 250u && (u & 0x7fffffffu) <= 0x7f800000u;",
                 "(u & 0x807fffffu) | 0x3f800000u",
                 "__fmul_rn(inv, __uint_as_float(eb << 23))",
                 "__uint_as_float((254u - eb) << 23)",
                 "__fmaf_rn(__fmaf_rn(-v.ds, q0, x), v.rs, q0)",
                 "__fmul_rn(finite ? q1 : q0, v.sc)",
                 "bad |= finite && (ax < 0x1p-102f || fabsf(q) <= 0x1p-126f);"):
        assert text in src, text


def rn32(v: Fraction) -> F32:
    """``v`` rounded to the nearest float32, ties to even (subnormals and
    overflow included; an exact 0 is +0)."""
    if v == 0:
        return F32(0.0)
    sign, a = (-1 if v < 0 else 1), abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(a, quantum)
    if rem * 2 > quantum or (rem * 2 == quantum and n % 2 == 1):
        n += 1
    out = n * quantum
    if out >= Fraction(2) ** 128:
        return F32(sign * np.inf)
    return F32(sign * float(out))


def divisor(d):
    """``kv3_divisor``: (ds, rs, sc, flag) of divisors d (arrays)."""
    d = np.asarray(d, F32)
    with np.errstate(all="ignore"):
        u = d.view(U32)
        eb = (u >> U32(23)) & U32(0xFF)
        ds = ((u & U32(0x807FFFFF)) | U32(0x3F800000)).view(F32)
        rs = (F32(1.0) / d) * (eb << U32(23)).view(F32)
        sc = ((U32(254) - eb) << U32(23)).view(F32)
        return ds, rs, sc, ((eb - U32(2)) > U32(250)) & ~np.isnan(d)


def quotient_exact(x: F32, d: F32):
    """The kernel's ``kv3_quotient(x, kv3_divisor(d, __frcp_rn(d)))`` and
    its flag, each operation rounded once from its exact value."""
    ds, rs, sc, bad = (v[()] for v in divisor(d))
    with np.errstate(all="ignore"):
        ax = abs(x)
        q0 = x * rs
        finite = ax != 0 and ax < np.inf
        if finite and not bad and not np.isnan(d):
            e = rn32(-Fraction(float(ds)) * Fraction(float(q0))
                     + Fraction(float(x)))
            q1 = rn32(Fraction(float(e)) * Fraction(float(rs))
                      + Fraction(float(q0)))
        else:
            q1 = q0    # NaN for a NaN d; a flagged divisor's is dropped
        q = q1 * sc
    return q, bool(bad or (finite and (ax < TINY or abs(q) <= 2.0 ** -126)))


def _fma_vector(e, r, q0):
    """fma(e, r, q0) rounded once: e r is exact in float64; the sum is the
    TwoSum pair (s, err), rounded by s unless s is a float32 midpoint,
    where err's sign decides and a zero err ties to even."""
    er = e.astype(np.float64) * r
    s = q0 + er
    t = s - q0
    err = (q0 - (s - t)) + (er - t)
    q = s.astype(F32)
    lo = np.nextafter(q, F32(-np.inf))
    hi = np.nextafter(q, F32(np.inf))
    for nb in (lo, hi):
        mid = (q.astype(np.float64) + nb) / 2 == s
        away = np.where(nb > q, err > 0, err < 0)
        tie = (err == 0) & ((nb.view(U32) & 1) == 0)
        q = np.where(mid & (away | tie), nb, q)
    return q


def quotient_vector(x, d):
    """``quotient_exact`` on arrays (d q0 is exact in float64, so e is one
    rounding of an exact value)."""
    x = np.asarray(x, F32)
    ds, rs, sc, bad = divisor(d)
    with np.errstate(all="ignore"):
        ax = np.abs(x)
        q0 = x * rs
        e = (-ds.astype(np.float64) * q0 + x).astype(F32)
        q1 = _fma_vector(e, rs, q0)
        finite = (ax != 0) & (ax < np.inf)
        q = np.where(finite, q1, q0) * sc
        return q, bad | (finite & ((ax < TINY) | (np.abs(q) <= 2.0 ** -126)))


def step_result(q, flag, x, d):
    """What the step uses: the quotient, or IEEE's where the flag is up."""
    with np.errstate(all="ignore"):
        return np.where(flag, np.asarray(x, F32) / d, q)


def same_bits(got, want):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    bad = (got.view(np.uint32) != want.view(np.uint32)) & ~nan
    assert not bad.any(), (np.nonzero(bad)[0][:5], got[bad][:5],
                           want[bad][:5])


def _specials():
    """Signed zeros, subnormals, infinities, NaN, the edges of the
    dividend's and the divisor's ranges and the float32 extremes, every
    pair of them."""
    tiny = np.array([1.4e-45, 1e-40, 1.1754942e-38], F32)
    edge = F32(2.0) ** np.arange(-104, -99, dtype=F32)
    vals = np.concatenate([
        [0.0, np.inf, np.nan, 1.0, 1.5, np.float32(3.4028235e38),
         1.1754944e-38, 2.0 ** -126, 2.0 ** -125, 2.0 ** -124,
         2.0 ** 125, 2.0 ** 126, 2.0 ** 127],
        tiny, edge, 1 / edge, np.nextafter(edge, F32(0)),
        np.nextafter(1 / edge, F32(np.inf))]).astype(F32)
    vals = np.concatenate([vals, -vals])
    x, d = np.meshgrid(vals, vals)
    return x.ravel(), d.ravel()


def _random(n=20000, seed=5):
    """Random pairs: mantissas uniform, exponents over float32's whole
    range (subnormal dividends included), signs mixed."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 2, (2, n))
    ex = rng.integers(-150, 128, (2, n))
    sgn = rng.choice([-1.0, 1.0], (2, n))
    x, d = (sgn * m * 2.0 ** ex).astype(F32)
    return x, d


def _exact(x, d):
    out = [quotient_exact(a, b) for a, b in zip(x, d)]
    return (np.array([q for q, _ in out], F32),
            np.array([f for _, f in out], bool))


def test_exact_quotient_on_special_operands():
    x, d = _specials()
    with np.errstate(all="ignore"):
        want = x / d
    q, flag = _exact(x, d)
    same_bits(step_result(q, flag, x, d), want)
    qv, fv = quotient_vector(x, d)
    assert np.array_equal(flag, fv)
    same_bits(step_result(qv, fv, x, d), want)
    # zeros, infinities, NaN and huge dividends need no flag where the
    # divisor is ordinary and the quotient normal
    easy = ~divisor(d)[3] & ((x == 0) | ~np.isfinite(x)
                             | ((np.abs(want) > 2.0 ** -126)
                                & (np.abs(x) >= TINY)))
    assert easy.sum() > 300 and not flag[easy].any()
    assert np.signbit(quotient_exact(F32(-0.0), F32(3.0))[0])
    assert not np.signbit(quotient_exact(F32(-0.0), F32(-3.0))[0])


def test_exact_quotient_on_random_pairs():
    """Random pairs over every exponent: the flag is up only for a divisor
    out of range, a dividend below 2^-102 or a subnormal quotient."""
    x, d = _random()
    with np.errstate(all="ignore"):
        want = x / d
    q, flag = _exact(x, d)
    same_bits(step_result(q, flag, x, d), want)
    qv, fv = quotient_vector(x, d)
    assert np.array_equal(flag, fv)
    same_bits(qv[~fv], q[~fv])
    finite = (x != 0) & np.isfinite(x)
    expected = divisor(d)[3] | (finite & ((np.abs(x) < TINY)
                                          | (np.abs(want) <= 2.0 ** -126)))
    assert np.array_equal(flag, expected)
    assert 0.1 < flag.mean() < 0.5


class _Divisions(TorchFunctionMode):
    """Records every float32 division's (dividend, divisor) pair."""

    def __init__(self):
        super().__init__()
        self.pairs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.Tensor.__truediv__, torch.div, torch.true_divide,
                    torch.Tensor.div) and out.dtype == torch.float32:
            a, b = (torch.as_tensor(v, dtype=torch.float32).expand_as(out)
                    for v in args[:2])
            self.pairs.append((a.reshape(-1).numpy().copy(),
                               b.reshape(-1).numpy().copy()))
        return out


def _captured(run):
    """The (x, d) pairs of every division ``run()`` makes inside
    ``kvaerno3_fixed_step``."""
    mode = _Divisions()

    def step(*a, **k):
        with mode:
            return kvaerno3_fixed_step(*a, **k)
    old, T.kvaerno3_fixed_step = T.kvaerno3_fixed_step, step
    try:
        run(step)
    finally:
        T.kvaerno3_fixed_step = old
    return (np.concatenate([p[0] for p in mode.pairs]),
            np.concatenate([p[1] for p in mode.pairs]))


@pytest.fixture(scope="module")
def twin_pairs():
    """The twin's divisions: zero_i around the demo (2,048 lanes of
    thetas around the defaults, 68 Kvaerno3 steps over the data's times at
    substeps 4, as config 6) and Robertson's first 20 steps of 1e-3 (the
    fit's first grid interval) from y0 = (1, 0, 0), 256 lanes of rates
    within 10 % of the defaults."""
    spec, obs, tf, y0 = demo_inputs()
    plan = T._build_plan(spec, obs, tf, 4)
    rng = np.random.default_rng(7)
    th = (np.array([0.6, 2.4e-8, 24.0])
          * np.exp(rng.normal(0, 0.2, (2048, 3)))).astype(F32)
    zx, zd = _captured(lambda _: T.make_scorer(spec, plan, y0, "kvaerno3")(
        list(torch.as_tensor(th.T.copy()))))
    rob = chemistry.robertson
    prog = rhs_program(rob.spec())
    ks = list(torch.as_tensor((np.asarray(rob.default_theta) * np.exp(
        rng.normal(0, 0.1, (256, 3)))).T.astype(F32).copy()))

    def robertson(step):
        y = [torch.full((256,), v) for v in (1.0, 0.0, 0.0)]
        for k in range(20):
            y = step(prog.evaluate, 1e-3 * k, y, 1e-3, ks,
                     prog.jacobian().evaluate)
            assert all(bool(torch.isfinite(v).all()) for v in y)
    rx, rd = _captured(robertson)
    return (zx, zd), (rx, rd)


def test_twin_operands_vectorized(twin_pairs):
    """Every pair the twin divides (zero_i: 68 x (2 reciprocals + 3 x 4 x
    2 back substitutions + 2 x 2 slopes) x 2,048; Robertson: 20 x (3 + 3 x
    4 x 3 + 2 x 3) x 256) gives IEEE's quotient; most take the corrected
    product or the zero branch, which is most of what chord Newton
    divides once converged."""
    for (x, d), n in zip(twin_pairs, (68 * 30 * 2048, 20 * 45 * 256)):
        assert len(x) == n
        with np.errstate(all="ignore"):
            want = x / d
        q, flag = quotient_vector(x, d)
        same_bits(step_result(q, flag, x, d), want)
        assert flag.mean() < 1e-4
        assert (x == 0).mean() > 0.2      # converged corrections


def test_twin_operands_exact(twin_pairs):
    """A sample of the twin's pairs, zeros and the guard's IEEE branch
    included, through the exact sequence."""
    rng = np.random.default_rng(3)
    for x, d in twin_pairs:
        pick = rng.choice(len(x), 4000, replace=False)
        x, d = x[pick], d[pick]
        with np.errstate(all="ignore"):
            want = x / d
        q, flag = _exact(x, d)
        same_bits(step_result(q, flag, x, d), want)


def _steps(spec):
    """The generated fast step's and IEEE fallback's bodies, comments
    dropped."""
    src = re.sub(r"//[^\n]*", "", build.kvaerno3_source(rhs_program(spec)))
    fast = src.index("void step_kvaerno3(")
    return src[fast:], src[src.index("step_kvaerno3_ieee("):fast]


@pytest.mark.parametrize("model", ["zero_i", "robertson"])
def test_step_takes_reciprocals_once_and_divides_nowhere_in_newton(model):
    """The generated step takes S + 1 reciprocals (each 1 / a_kk and 1 /
    hg) before its stages, has no '/' at all (so none inside a chord-Newton
    loop or in the stage slopes), takes S kv3_quotient calls a Newton
    iteration, and falls back on a step of the twin's IEEE divisions."""
    spec = zero_i.spec() if model == "zero_i" else \
        chemistry.robertson.spec()
    S = len(spec.snames)
    body, ieee = _steps(spec)
    assert body.count("__frcp_rn(") == S + 1
    assert "/" not in body
    loops = re.findall(r"for \(int it = 0; it < (\d+); \+\+it\) \{(.*?)\n  \}",
                       body, re.S)
    assert len(loops) == 3 and all(int(n) == KV3_NEWTON for n, _ in loops)
    for _, loop in loops:
        assert loop.count("kv3_quotient(") == S
    assert body.count("kv3_quotient(") == 3 * S + 2 * S
    first = body.index("for (int it")
    assert body[:first].count("__frcp_rn(") == S + 1
    assert "if (bad) {" in body and "step_kvaerno3_ieee(in, sf, ps, uf)" \
        in body
    # the fallback, in loops over ODE_S: the twin's reciprocal for the
    # elimination, a quotient in each stage's Newton loop, the two slopes
    assert "__frcp_rn" not in ieee and "kv3_quotient" not in ieee
    assert ieee.count("1.0f / A[k * ODE_S + k]") == 1
    assert ieee.count("x[i] = x[i] / A[i * ODE_S + i];") == 3
    assert ieee.count("[s] = (z[s] - b[s]) / hg;") == 2
    assert ieee.count("/") == 6
