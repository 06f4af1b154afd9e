"""odelib_tpu_torch/utils/model_comparison.py, the port's numpy copy,
against odelib_tpu/utils/model_comparison.py on seeded arrays, bitwise:
WAIC, PSIS-LOO (every observation's k-hat), the ranking of ``compare``
and the Pareto smoothing ``_psis_smooth_lw`` (with its GPD fit), on a
heavy-tailed log-likelihood matrix, one with a few influential points and
on a short draw whose tail is too small to fit."""
import numpy as np
import pytest

from odelib_tpu.utils import model_comparison as J
from odelib_tpu_torch.utils import model_comparison as T


def loglik(kind):
    rng = np.random.default_rng({"heavy": 1, "influential": 2,
                                 "short": 3}[kind])
    if kind == "short":
        return rng.normal(-1.0, 0.5, (12, 5))
    ll = rng.standard_t(4, (400, 30)) - 2.0
    if kind == "influential":
        ll[:, :3] -= rng.gamma(1.0, 6.0, (400, 3))
    return ll


def _same(a, b):
    """Equal results: dicts key by key, tuples and lists item by item,
    arrays and floats bitwise."""
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _compare(m, ll):
    """Three models ranked by elpd_loo (higher better) and by WAIC (lower
    better)."""
    crit = {"a": m.psis_loo(ll), "b": m.psis_loo(ll * 1.01),
            "c": m.psis_loo(ll - 0.1)}
    waics = {k: m.waic(v) for k, v in
             (("a", ll), ("b", ll * 1.01), ("c", ll - 0.1))}
    return m.compare(crit), m.compare(waics, key="waic")


CALLS = {
    "waic": lambda m, ll: m.waic(ll),
    "psis_loo": lambda m, ll: m.psis_loo(ll),
    "compare": _compare,
    "psis_smooth_lw": lambda m, ll: [m._psis_smooth_lw(-ll[:, i])
                                     for i in range(ll.shape[1])],
}


@pytest.mark.parametrize("kind", ["heavy", "influential", "short"])
@pytest.mark.parametrize("fn", list(CALLS))
def test_model_comparison_bitwise(fn, kind):
    ll = loglik(kind)
    got, ref = CALLS[fn](T, ll), CALLS[fn](J, ll)
    _same(got, ref)
    if fn == "psis_loo" and kind == "influential":
        assert got["n_bad_khat"] > 0
