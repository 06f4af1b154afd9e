"""The ``jax.random`` stream of the scan samplers, in torch.

Counterpart of the parts of ``jax.random`` that ``odelib_tpu``'s XLA
samplers draw from (``samplers/mh.py``, ``ensemble.py``, ``pt.py`` and the
chain keys of ``dispatch.py``): the Threefry-2x32 hash and the
``threefry_partitionable`` key derivation of jax 0.9, vectorised over a
batch of keys. A key is an int64 tensor of shape ``(..., 2)`` holding two
uint32 words; every function takes a batch of keys and acts on each key as
``jax.random`` acts on one, so a ``vmap`` over keys in the reference is the
leading axes here.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF``: torch has no
uint32 ``+`` or ``>>`` on the CPU. Bits, uniforms and ``randint`` are
bitwise ``jax.random``'s; ``normal`` is ``sqrt(2) * erfinv(u)`` of
``jax.random``'s uniform on ``(nextafter(-1, 0), 1)``, with ``erfinv`` and
its ``log1p`` computed as XLA:CPU expands them (the same polynomials and
fused multiply-adds), so a float64 normal differs from the reference only
where the two libraries' ``log`` round differently (a float32 one also
where XLA's own float32 ``log`` does). ``exponential``, ``gamma``
(Marsaglia and Tsang, each rejection loop masked over the batch), ``t``
and ``poisson`` (Knuth below a rate of 10, Hörmann's transformed
rejection above, in float32) follow jax 0.9's algorithms on the same key
derivation (SBC's Student-t and count data draw them). Seeds, integer
draws and fold-in data follow ``jax_enable_x64=True`` (the JAX package's
tests' setting): a Python seed is a 64-bit value and ``randint`` draws
int64 by default.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x1, x2)``
    under the key words ``(k1, k2)``; int64 tensors of uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & M32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a Python integer seed: its 64-bit
    value's high and low words (``jax_enable_x64=True``)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64, device=device)


def key_data(keys: torch.Tensor) -> np.ndarray:
    """The keys' words as a uint32 array (``jax.random.key_data``), the form
    a checkpoint stores."""
    return keys.cpu().numpy().astype(np.uint32)


def wrap_key_data(data, device=None) -> torch.Tensor:
    """Keys from their words (``jax.random.wrap_key_data``): a uint32 array
    of shape ``(..., 2)``, or the int64 words."""
    return torch.as_tensor(np.asarray(data).astype(np.int64) & M32,
                           device=device)


def _words(keys):
    return keys[..., 0], keys[..., 1]


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key: ``data`` (an int, or an integer
    tensor broadcast against the keys' batch shape) is taken mod 2**32,
    as ``jnp.asarray(data, 'uint32')``."""
    k1, k2 = _words(keys)
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def _counts(shape, device):
    """``iota_2x32_shape``: the row-major flat index of every position of
    ``shape`` as its high and low words."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError("the port draws fewer than 2**32 values a key")
    lo = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return torch.zeros_like(lo), lo


def _hash_shape(keys, shape):
    """The partitionable hash of every position of ``shape`` under each
    key: two word tensors of shape ``keys.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counts(shape, keys.device)
    k1, k2 = _words(keys)
    ex = (...,) + (None,) * len(shape)
    return threefry2x32(k1[ex], k2[ex], hi, lo)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of each key: ``(..., num, 2)``."""
    b1, b2 = _hash_shape(keys, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` of each key, as int64."""
    b1, b2 = _hash_shape(keys, shape)
    return b1 ^ b2


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` of each key: ``arange(n)`` put
    through ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each splitting the key
    and stably sorting by 32-bit words drawn over the positions (jax's
    ``_shuffle``; equal words keep their order, as the sort is stable).
    Returns int64 ``keys.shape[:-1] + (n,)``."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, device=keys.device).expand(keys.shape[:-1] + (n,))
    for _ in range(rounds):
        keys, sub = split(keys).unbind(-2)
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.take_along_dim(x, order, dim=-1)
    return x


def _split(x):
    """Veltkamp's split of x into two halves whose products are exact."""
    c = x * (134217729.0 if x.dtype == torch.float64 else 4097.0)
    hi = c - (c - x)
    return hi, x - hi


def _fma(a, b, bh, bl, c):
    """a * b + c rounded once, ``(bh, bl)`` the split of b."""
    p = a * b
    ah, al = _split(a)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def fma(a, b, c):
    """a * b + c rounded once (to within rare double roundings), from
    error-free products and sums: XLA:CPU's LLVM code contracts a multiply
    that feeds one add into a fused multiply-add, and torch has none."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return _fma(a, b, *_split(b), c)


def _horner(coefs, x):
    """Fused Horner steps of the polynomial ``coefs`` (highest power
    first, any iterable: Python floats, or tensors broadcast against x) at
    x, whose split is taken once."""
    xh, xl = _split(x)
    coefs = iter(coefs)
    p = torch.as_tensor(next(coefs), dtype=x.dtype, device=x.device) \
        .expand_as(x)
    for c in coefs:
        p = _fma(p, x, xh, xl, c)
    return p


def uniform(keys: torch.Tensor, shape=(), dtype=torch.float64,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` of each
    key: the mantissa of a float in [1, 2) from the top random bits, minus
    one, scaled into [minval, maxval) and clipped below at minval."""
    b1, b2 = _hash_shape(keys, shape)
    if dtype == torch.float64:
        # the 64-bit draw (b1 << 32 | b2) >> 12, ORed into 1.0's exponent
        fb = ((b1 << 20) | (b2 >> 12)) | 0x3FF0000000000000
        floats = fb.view(torch.float64) - 1.0
    elif dtype == torch.float32:
        fb = ((b1 ^ b2) >> 9) | 0x3F800000
        floats = fb.to(torch.int32).view(torch.float32) - 1.0
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=keys.device)
    span = torch.tensor(maxval, dtype=dtype, device=keys.device) - lo
    if math.frexp(float(span))[0] == 0.5:
        # a power of two: the product is exact, the fused sum a plain one
        return torch.maximum(lo, floats * span + lo)
    return torch.maximum(lo, fma(floats, span, lo))


# Giles' erfinv polynomials as XLA expands ``erf_inv`` (coefficients read
# from the HLO that jax 0.9 lowers ``lax.erf_inv`` to), highest power first:
# per region of w = -log1p(-x^2), the shift of w (or of sqrt(w)) and the
# coefficients
_ERFINV64 = (
    (6.25, 3.125, False, (
        -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
        1.1157877678025181e-17, -1.333171662854621e-16,
        2.0972767875968562e-17, 6.637638134358324e-15,
        -4.054566272975207e-14, -8.151934197605472e-14,
        2.6335093153082323e-12, -1.2975133253453532e-11,
        -5.415412054294628e-11, 1.0512122733215323e-09,
        -4.112633980346984e-09, -2.9070369957882005e-08,
        4.2347877827932404e-07, -1.3654692000834679e-06,
        -1.3882523362786469e-05, 0.00018673420803405714,
        -0.000740702534166267, -0.0060336708714301491, 0.24015818242558962,
        1.6536545626831027)),
    (16.0, 3.25, True, (
        2.2137376921775787e-09, 9.075656193888539e-08,
        -2.7517406297064545e-07, 1.8239629214389228e-08,
        1.5027403968909828e-06, -4.013867526981546e-06,
        2.9234449089955446e-06, 1.2475304481671779e-05,
        -4.7318229009055734e-05, 6.828485145957318e-05,
        2.4031110387097894e-05, -0.0003550375203628475,
        0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
        -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
        3.0838856104922208)),
    (math.inf, 5.0, True, (
        -2.7109920616438573e-11, -2.555641816996525e-10,
        1.5076572693500548e-09, -3.789465440126737e-09,
        7.61570120807834e-09, -1.496002662714924e-08, 2.914795345090108e-08,
        -6.771199775845234e-08, 2.2900482228026655e-07,
        -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
        7.599527703001776e-05, -0.00021503011930044477,
        -0.00013871931833623122, 1.0103004648645344, 4.849906401408584)))
_ERFINV32 = (
    (5.0, 2.5, False, (
        2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
        1.50140941)),
    (math.inf, 3.0, True, (
        -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
        2.83297682)))


# XLA:CPU's log1p below |x| = sqrt(2) - 1: Cephes' rational form, the
# numerator's and denominator's coefficients highest power first (in a
# float32 expansion rounded to float32); above it, log(1 + x)
_LOG1P_SMALL = 0.41421356237309503
_LOG1P_NUM = (4.52700008624452e-05, 0.49854102823193375, 6.578732594206104,
              29.911919328553072, 60.94966798098779, 57.11296359058554,
              20.039553499201283)
_LOG1P_DEN = (1.0, 15.062909083469192, 83.04756596796722, 221.76239823732857,
              309.09872225312057, 216.42788614495947, 60.11866049760384)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` as XLA:CPU computes it inside ``erf_inv``: near zero
    ``x + fma(x^2, -1/2, x^3 N(x) / D(x))``, N and D by fused Horner
    steps, else ``log(1 + x)`` (torch's ``log``; XLA's float32 one is a
    polynomial of its own)."""
    rnd = float if x.dtype == torch.float64 else \
        (lambda v: float(np.float32(v)))
    x2 = x * x
    ratio = _horner([rnd(c) for c in _LOG1P_NUM], x) \
        / _horner([rnd(c) for c in _LOG1P_DEN], x)
    small = x + fma(x2, -0.5, (x * x2) * ratio)
    return torch.where(torch.abs(x) < rnd(_LOG1P_SMALL), small,
                       torch.log(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function as XLA computes ``erf_inv`` (float32 or
    float64): fused Horner steps on the region's polynomial, times x;
    +-inf at +-1. A shorter polynomial leads with zeros, whose steps give
    its first coefficient exactly, as XLA's selected-away steps do."""
    table = _ERFINV64 if x.dtype == torch.float64 else _ERFINV32
    w = -log1p(-x * x)
    n = len(table[0][3])
    coefs = torch.tensor([[0.0] * (n - len(c)) + list(c)
                          for _, _, _, c in table], dtype=x.dtype,
                         device=x.device)
    region = torch.zeros_like(x, dtype=torch.int64)
    for k, (bound, _, _, _) in enumerate(table[:-1]):
        region = torch.where((region == k) & ~(w < bound), k + 1, region)
    sw = torch.sqrt(w)
    v = torch.empty_like(x)
    for k, (_, shift, root, _) in enumerate(table):
        v = torch.where(region == k, (sw if root else w) - shift, v)
    # each step's coefficients gathered as the step needs them: one
    # tensor of x's size at a time, not the (n, ...) table of every step
    p = _horner((row[region] for row in coefs.t()), v)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(keys: torch.Tensor, shape=(), dtype=torch.float64) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` of each key:
    ``sqrt(2) * erfinv(u)``, u uniform on (nextafter(-1, 0), 1)."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(npd(-1.0), npd(0.0)))
    u = uniform(keys, shape, dtype, lo, 1.0)
    return float(npd(np.sqrt(2))) * erfinv(u)


def _mod64(hi, lo, span):
    """(hi * 2**32 + lo) mod span for words hi, lo and span < 2**31."""
    return ((hi % span) * ((2 ** 32) % span) + lo % span) % span


def randint(keys: torch.Tensor, shape, minval: int, maxval: int,
            dtype=torch.int64) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` of each
    key (int64 is the reference's default under x64, int32 its default
    otherwise): two draws of the dtype's width from ``split(key)``,
    combined modulo the span ``maxval - minval`` (below 2**31 here)."""
    minval, maxval = int(minval), int(maxval)
    span = max(maxval - minval, 1)
    if span >= 2 ** 31:
        raise ValueError("randint spans below 2**31 only")
    ks = split(keys)
    hb, lb = _hash_shape(ks[..., 0, :], shape), _hash_shape(ks[..., 1, :],
                                                             shape)
    if dtype == torch.int64:
        mult = (2 ** 32 % span) ** 2 % span
        hm, lm = _mod64(*hb, span), _mod64(*lb, span)
        off = (hm * mult + lm) % span
    elif dtype == torch.int32:
        mult = ((2 ** 16 % span) ** 2 & M32) % span
        hm, lm = (hb[0] ^ hb[1]) % span, (lb[0] ^ lb[1]) % span
        off = ((((hm * mult) & M32) + lm) & M32) % span
    else:
        raise TypeError(f"randint draws int32 or int64, not {dtype}")
    return (minval + off).to(dtype)


def exponential(keys: torch.Tensor, shape=(), dtype=torch.float64
                ) -> torch.Tensor:
    """``jax.random.exponential(key, shape, dtype)`` of each key:
    ``-log1p(-u)``, u ``jax.random``'s uniform, the ``log1p`` XLA's
    (:func:`log1p`)."""
    return -log1p(-uniform(keys, shape, dtype))


def _gamma_one(keys, alpha):
    """``jax.random``'s ``_gamma_one`` (Marsaglia and Tsang, with the
    boost ``Gamma(a) = Gamma(a + 1) U^(1/a)`` below a = 1) of every key
    ``(..., 2)`` at its ``alpha`` ``(...)``: each rejection loop a masked
    loop over the batch, a lane's draws taken only while its own loop
    runs."""
    dt = alpha.dtype
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - 1.0 / 3.0
    c = (1.0 / 3.0) / torch.sqrt(d)
    keys, sub = split(keys).unbind(-2)
    X = torch.zeros_like(a)
    V = torch.ones_like(a)
    U = torch.full_like(a, 2.0)

    def running(X, V, U):
        return (U >= 1.0 - 0.0331 * (X * X)) & (
            torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V)))

    run = running(X, V, U)
    while bool(run.any()):
        keys_n, x_key, u_key = split(keys, 3).unbind(-2)
        x = torch.zeros_like(a)
        v = torch.full_like(a, -1.0)
        inner = run.clone()
        while bool(inner.any()):
            x_next, s = split(x_key).unbind(-2)
            xn = normal(s, (), dt)
            x_key = torch.where(inner[..., None], x_next, x_key)
            x = torch.where(inner, xn, x)
            v = torch.where(inner, fma(xn, c, 1.0), v)
            inner = inner & (v <= 0.0)
        keys = torch.where(run[..., None], keys_n, keys)
        X = torch.where(run, x * x, X)
        V = torch.where(run, (v * v) * v, V)
        U = torch.where(run, uniform(u_key, (), dt), U)
        run = run & running(X, V, U)
    samples = 1.0 - uniform(sub, (), dt)
    b = torch.where(boost, torch.ones_like(a),
                    torch.pow(samples, 1.0 / alpha))
    return (d * V) * b


def gamma(keys: torch.Tensor, a, shape=None, dtype=torch.float64
          ) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape, dtype)`` of each key: ``a``
    broadcast to the keys' batch shape + ``shape`` (default: ``a``'s
    dimensions past the keys' batch), element j drawn by
    :func:`_gamma_one` from ``split(key, prod(shape))[j]``."""
    a = torch.as_tensor(a, dtype=dtype, device=keys.device)
    lead = tuple(keys.shape[:-1])
    shape = tuple(a.shape[len(lead):]) if shape is None \
        else tuple(int(s) for s in shape)
    n = math.prod(shape)
    subs = split(keys, n)                          # (..., n, 2)
    alpha = a.expand(lead + shape).reshape(lead + (n,))
    return _gamma_one(subs, alpha).reshape(lead + shape)


def t(keys: torch.Tensor, df, shape=(), dtype=torch.float64) -> torch.Tensor:
    """``jax.random.t(key, df, shape, dtype)`` of each key: ``n sqrt(df/2
    / g)``, n normal from the key's first split and g :func:`gamma` of
    ``df / 2`` from its second."""
    key_n, key_g = split(keys).unbind(-2)
    n = normal(key_n, shape, dtype)
    half = torch.as_tensor(df, dtype=dtype, device=keys.device) / 2.0
    g = gamma(key_g, half, shape, dtype)
    return n * torch.sqrt(half / g)


def _fma32(a, b, c):
    """a * b + c of float32 values rounded once to float32 (XLA:CPU
    contracts such a pair): the product is exact in float64, and the
    float64 sum rounds to float32 as the fused result does but for a sum
    on a float32 halfway point, a case of about one in 2**29."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b, c))
    return (a.double() * b.double() + c.double()).float()


def _poisson_knuth(keys, lam, nd):
    """Knuth's product of uniforms (``jax.random``'s ``_poisson_knuth``):
    float32 uniforms and their float32 logs, one draw over the whole shape
    each round while any element of any key still runs (an element that
    stopped keeps its count)."""
    k = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    log_prod = torch.zeros(lam.shape, dtype=torch.float32,
                           device=lam.device)
    shape = tuple(lam.shape[len(lam.shape) - nd:])
    while True:
        going = log_prod > -lam
        if not bool(going.any()):
            break
        keys, sub = split(keys).unbind(-2)
        k = torch.where(going, k + 1, k)
        log_prod = log_prod + torch.log(uniform(sub, shape, torch.float32))
    return k - 1


def _poisson_rejection(keys, lam, nd):
    """Hörmann's transformed rejection (``jax.random``'s
    ``_poisson_rejection``) in float32: a key's round draws two uniforms
    over its whole shape, and every accepted element takes that round's
    count, until each element of the key has been accepted once (a key
    that is done draws no more)."""
    f32 = torch.float32
    log_lam = torch.log(lam)
    b = _fma32(2.53, torch.sqrt(lam), 0.931)
    a = _fma32(0.02483, b, -0.059)
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2.0)
    shape = tuple(lam.shape[len(lam.shape) - nd:])
    red = tuple(range(-nd, 0))
    k_out = torch.full(lam.shape, -1.0, dtype=f32, device=lam.device)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    while True:
        running = ~accepted.all(dim=red) if nd else ~accepted
        if not bool(running.any()):
            break
        run = running.reshape(running.shape + (1,) * nd)
        keys, s0, s1 = split(keys, 3).unbind(-2)
        u = uniform(s0, shape, f32) - 0.5
        v = uniform(s1, shape, f32)
        us = 0.5 - torch.abs(u)
        k = torch.floor(_fma32(2.0 * a / us + b, u, lam) + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        tt = _fma32(k, log_lam, -lam) - torch.lgamma(k + 1.0)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = (accept1 | (~reject & (s <= tt))) & run
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(torch.int64)


def poisson(keys: torch.Tensor, lam, shape=None, dtype=torch.int64
            ) -> torch.Tensor:
    """``jax.random.poisson(key, lam, shape, dtype)`` of each key: ``lam``
    broadcast to the keys' batch shape + ``shape`` (default: ``lam``'s
    dimensions past the keys' batch) and rounded to float32, Knuth's
    method below 10 (and at NaN), the transformed rejection from 10, both
    run on the key (each with a placeholder rate where the other applies,
    as jax runs them: the placeholders take part in the rounds), 0 where
    lam is 0. The rejection's float32 ``log`` and ``lgamma`` are torch's,
    not XLA's: above a rate of about 10^3 a draw may differ from jax's,
    and since jax's rounds re-accept, a key's other draws with it."""
    lam = torch.as_tensor(lam, device=keys.device)
    lead = tuple(keys.shape[:-1])
    shape = tuple(lam.shape[len(lead):]) if shape is None \
        else tuple(int(s) for s in shape)
    lam = lam.to(torch.float32).expand(lead + shape)
    nd = len(shape)
    knuth = torch.isnan(lam) | (lam < 10)
    lam_k = torch.where(knuth, lam, torch.zeros_like(lam))
    lam_r = torch.where(knuth, torch.full_like(lam, 1e5), lam)
    out = torch.where(knuth, _poisson_knuth(keys, lam_k, nd),
                      _poisson_rejection(keys, lam_r, nd))
    return torch.where(lam == 0, torch.zeros_like(out), out).to(dtype)
