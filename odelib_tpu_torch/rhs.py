"""RHS front end: trace the user's right-hand side once into an expression
DAG, then evaluate it with torch or emit it as CUDA device code.

The JAX package traces the user's ``jnp`` RHS straight into its Pallas
kernels. A hand-written CUDA kernel cannot trace Python, so the port calls
the RHS once with proxy objects for ``t``, ``y`` and ``ps``; every
arithmetic operation records a node. Two things are emitted from the DAG:

* :meth:`RhsProgram.evaluate` — a torch evaluator over per-state tensors,
  used by the kernels' plain twins and by the adaptive integrator;
* :meth:`RhsProgram.cuda_source` — a ``__device__`` function compiled into
  the survey and MH kernels (``ops/csrc/mh.cu``).

Both keep Python's evaluation order, and constants are rounded to float32
exactly as JAX rounds a weakly-typed Python scalar against a float32 array,
so the kernel, its twin and the JAX reference perform the same float32
operations in the same order. Python scalar arithmetic that happens before
a traced value is involved (``2.0 * 3.0 * S``) folds in double, as it does
under JAX.

During tracing (and eager evaluation) the function's globals ``np``,
``numpy``, ``jnp`` and ``torch`` are rebound to a small shim providing
``array``/``asarray``/``stack``, ``exp``, ``log``, ``sqrt``, ``abs``,
``minimum``, ``maximum`` and ``where``, so the reference's numpy style, the
JAX package's ``jnp`` style and torch style all run unchanged. An RHS that
does not trace (Python control flow on a state, matrix products, other
library calls) raises :class:`RhsTraceError` naming the construct; the CPU
twins then run it eagerly through torch, the CUDA kernels refuse it.
"""
from __future__ import annotations

import inspect
import math
import types
from functools import lru_cache

import numpy as np
import torch


class RhsTraceError(ValueError):
    """The RHS uses a construct the tracer cannot turn into device code."""


_SUPPORTED = ("array", "asarray", "stack", "exp", "log", "sqrt", "abs",
              "minimum", "maximum", "where")


class _Graph:
    """Hash-consed node table of one trace (structural CSE: the same
    operation on the same operands is one node)."""

    def __init__(self):
        self.nodes = []
        self._index = {}

    def node(self, op, args=(), value=None):
        key = (op, tuple(a.id for a in args),
               value.hex() if isinstance(value, float) else value)
        n = self._index.get(key)
        if n is None:
            n = Expr(self, len(self.nodes), op, tuple(args), value)
            self.nodes.append(n)
            self._index[key] = n
        return n

    def lift(self, x):
        if isinstance(x, Expr):
            if x.g is not self:
                raise RhsTraceError("values from two different traces mixed")
            return x
        if isinstance(x, (bool, int, float, np.number)) or (
                isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim == 0):
            return self.node("const", value=float(x))
        raise RhsTraceError(
            f"unsupported value of type {type(x).__name__} in the RHS "
            "(only scalars, states and parameters trace)")

    def ipow(self, x, n):
        """``x ** n`` for a Python int ``n``: JAX's ``integer_pow``
        (repeated squaring, reciprocal for negative n)."""
        if n == 0:
            return self.lift(1.0)
        neg, n, acc = n < 0, abs(n), None
        while n > 0:
            if n & 1:
                acc = x if acc is None else self.node("mul", (acc, x))
            n >>= 1
            if n > 0:
                x = self.node("mul", (x, x))
        return self.node("div", (self.lift(1.0), acc)) if neg else acc


def _no(what):
    def f(self, *a, **k):
        raise RhsTraceError(f"{what} is not supported by the RHS tracer")
    return f


class Expr:
    """A traced scalar value (one lane of a state, parameter or result)."""
    __slots__ = ("g", "id", "op", "args", "value")
    __array_ufunc__ = None      # numpy scalars defer to our reflected ops
    __hash__ = None

    def __init__(self, g, id_, op, args, value):
        self.g, self.id, self.op, self.args, self.value = \
            g, id_, op, args, value

    def _bin(self, op, other, rev=False):
        o = self.g.lift(other)
        return self.g.node(op, (o, self) if rev else (self, o))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, True)
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __eq__(self, o): return self._bin("eq", o)
    def __ne__(self, o): return self._bin("ne", o)
    def __neg__(self): return self.g.node("neg", (self,))
    def __pos__(self): return self
    def __abs__(self): return self.g.node("abs", (self,))

    def __pow__(self, o):
        if isinstance(o, (int, np.integer)) and not isinstance(o, bool):
            return self.g.ipow(self, int(o))
        return self._bin("pow", o)

    def __rpow__(self, o):
        return self._bin("pow", o, True)

    __bool__ = _no("Python control flow (if/while/and/or/not, builtin "
                   "min/max) on a traced value — use np.where, np.minimum "
                   "or np.maximum —")
    __float__ = __int__ = __index__ = __complex__ = _no(
        "converting a traced value to a Python number (float(), int(), "
        "math.* functions)")
    __len__ = __iter__ = __getitem__ = _no(
        "indexing or iterating a scalar state or parameter (array "
        "parameters)")
    __matmul__ = __rmatmul__ = _no("the matrix product '@'")
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _no(
        "floor division and modulo")


class _Vec:
    """The traced state vector: supports ``y[i]``, unpacking and len()."""

    def __init__(self, items):
        self._items = list(items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _Vec(self._items[i])
        if isinstance(i, (int, np.integer)):
            return self._items[int(i)]
        raise RhsTraceError("indexing the state vector with a "
                            f"{type(i).__name__} is not supported")

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)

    @property
    def shape(self):
        return (len(self._items),)


def _exprs(args):
    for a in args:
        if isinstance(a, Expr):
            yield a
        elif isinstance(a, (list, tuple, _Vec)):
            yield from _exprs(a)


def _first_expr(*args):
    return next(_exprs(args), None)


def _eager_stack(vals):
    ref = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    if ref is None:
        return torch.as_tensor(vals)
    dtype = ref.dtype
    for v in vals:
        if isinstance(v, torch.Tensor):
            dtype = torch.promote_types(dtype, v.dtype)
    ts = [v.to(dtype) if isinstance(v, torch.Tensor)
          else torch.as_tensor(v, dtype=dtype, device=ref.device)
          for v in vals]
    return torch.stack(torch.broadcast_tensors(*ts))


class _Shim:
    """Stands in for ``np``/``numpy``/``jnp``/``torch`` inside the RHS.
    Traced operands build DAG nodes; tensors run the torch operation."""
    pi, e, inf, nan = math.pi, math.e, math.inf, math.nan

    def __init__(self, name):
        self._name = name

    def _unary(op, torch_fn):
        def f(self, x):
            if isinstance(x, Expr):
                return x.g.node(op, (x,))
            return torch_fn(torch.as_tensor(x))
        return f

    exp = _unary("exp", torch.exp)
    log = _unary("log", torch.log)
    sqrt = _unary("sqrt", torch.sqrt)
    abs = absolute = _unary("abs", torch.abs)
    del _unary

    def _binary(op, torch_fn):
        def f(self, a, b):
            x = _first_expr(a, b)
            if x is not None:
                return x.g.node(op, (x.g.lift(a), x.g.lift(b)))
            a, b = torch.broadcast_tensors(*_eager_stack([a, b]))
            return torch_fn(a, b)
        return f

    minimum = _binary("minimum", torch.minimum)
    maximum = _binary("maximum", torch.maximum)
    del _binary

    def where(self, c, a, b):
        x = _first_expr(c, a, b)
        if x is not None:
            return x.g.node("where", tuple(x.g.lift(v) for v in (c, a, b)))
        a, b = _eager_stack([a, b])
        return torch.where(torch.as_tensor(c), a, b)

    def stack(self, seq, axis=0, dtype=None, **kw):
        seq = list(seq)
        x = _first_expr(seq)
        if x is not None:
            return [x.g.lift(v) for v in seq]
        return _eager_stack(seq)

    def array(self, seq, dtype=None, **kw):
        if isinstance(seq, (list, tuple, _Vec)):
            return self.stack(seq)
        return seq if isinstance(seq, Expr) else torch.as_tensor(seq)

    asarray = array

    def __getattr__(self, name):
        attr = getattr(torch, name)
        if not callable(attr) or isinstance(attr, type):
            return attr

        def f(*args, **kw):
            if _first_expr(args, tuple(kw.values())) is not None:
                raise RhsTraceError(
                    f"{self._name}.{name} is not supported by the RHS "
                    f"tracer (supported: {', '.join(_SUPPORTED)})")
            return attr(*args, **kw)
        return f


_SHIM_NAMES = ("np", "numpy", "jnp", "torch")


def rebind_globals(f):
    """Copy of ``f`` whose ``np``/``numpy``/``jnp``/``torch`` globals are
    the shim (functions without ``__code__`` pass through)."""
    if not hasattr(f, "__code__"):
        return f
    g = dict(f.__globals__)
    for name in _SHIM_NAMES:
        g[name] = _Shim(name)
    return types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                              f.__closure__)


def infer_style(f) -> str:
    """'jax' for ``f(t, y, ps)``, 'reference' for ``f(y, t, ps)``, decided
    by argument names exactly like ``odelib_tpu``'s ``_adapt_rhs``."""
    time_names = {"t", "time", "times"}
    state_names = {"y", "state", "states", "u", "x"}
    try:
        args = list(inspect.getfullargspec(f).args)
    except TypeError:
        return "reference"
    if args and args[0] in ("self", "cls"):
        args = args[1:]
    a0 = args[0].lower() if len(args) > 0 else ""
    a1 = args[1].lower() if len(args) > 1 else ""
    if a0 in time_names or a1 in state_names:
        return "jax"
    if a0 in state_names or a1 in time_names:
        return "reference"
    raise ValueError(
        f"cannot infer the RHS argument convention from signature {args!r}: "
        "name the first two arguments like (y, t, ...) [reference] or "
        "(t, y, ...) [jax], or pass ode_style='reference'|'jax'")


def adapt_rhs(f, style="auto"):
    """The user's RHS as ``g(t, y, ps)`` with rebound globals."""
    if style == "auto":
        style = infer_style(f)
    rf = rebind_globals(f)
    if style == "reference":
        return lambda t, y, ps: rf(y, t, ps)
    return lambda t, y, ps: rf(t, y, ps)


_PY_OPS = {"add": "+", "sub": "-", "mul": "*", "div": "/", "lt": "<",
           "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_BOOL_OPS = {"lt", "le", "gt", "ge", "eq", "ne"}
_CUDA_FN = {"exp": "expf", "log": "logf", "sqrt": "sqrtf", "abs": "fabsf",
            "pow": "powf"}
_TORCH_FN = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
             "div": torch.div, "pow": torch.pow, "neg": torch.neg,
             "abs": torch.abs, "exp": torch.exp, "log": torch.log,
             "sqrt": torch.sqrt, "minimum": torch.minimum,
             "maximum": torch.maximum, "where": torch.where,
             "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
             "eq": torch.eq, "ne": torch.ne}


def _f32_literal(v: float) -> str:
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    s = str(np.float32(v))          # shortest repr that round-trips in f32
    if "." not in s and "e" not in s:
        s += ".0"
    return f"{s}f" if not s.startswith("-") else f"({s}f)"


class RhsProgram:
    """A traced RHS: ``n_states`` outputs over states, parameters and t."""

    def __init__(self, graph, outputs, n_states, n_params, name="rhs"):
        self.nodes = graph.nodes
        self.outputs = tuple(outputs)
        self.n_states, self.n_params, self.name = n_states, n_params, name
        live, stack = set(), list(self.outputs)
        while stack:
            n = stack.pop()
            if n.id not in live:
                live.add(n.id)
                stack.extend(n.args)
        self.order = [n for n in self.nodes if n.id in live]
        self._consts = {}

    def evaluate(self, t, y, ps):
        """Torch evaluation: ``y`` is a sequence of S tensors, ``ps`` of P
        tensors (or scalars); returns S tensors of the broadcast shape."""
        ref = y[0]
        key = (ref.dtype, ref.device)
        consts = self._consts.setdefault(key, {})
        val = {}
        for n in self.order:
            if n.op == "const":
                v = consts.get(n.id)
                if v is None:
                    v = consts[n.id] = torch.tensor(
                        n.value, dtype=ref.dtype, device=ref.device)
            elif n.op == "y":
                v = y[n.value]
            elif n.op == "p":
                v = torch.as_tensor(ps[n.value], dtype=ref.dtype,
                                    device=ref.device)
            elif n.op == "t":
                v = torch.as_tensor(t, dtype=ref.dtype, device=ref.device)
            else:
                v = _TORCH_FN[n.op](*(val[a.id] for a in n.args))
            val[n.id] = v
        shape = torch.broadcast_shapes(
            *(v.shape for v in y),
            *(val[n.id].shape for n in self.order if n.op == "p"))
        return [torch.broadcast_to(val[o.id], shape) for o in self.outputs]

    def cuda_source(self) -> str:
        """The RHS as ``__device__ void rhs(float t, const float* y,
        const float* p, float* dy)`` after the ``ODE_S``/``ODE_P``
        defines, one SSA statement per node."""
        return "\n".join([f"// traced from {self.name}",
                          f"#define ODE_S {self.n_states}",
                          f"#define ODE_P {self.n_params}",
                          self.cuda_function("rhs")])

    def cuda_function(self, fn_name: str) -> str:
        """The traced function as ``__device__ void <fn_name>(float t,
        const float* y, const float* p, float* dy)``."""
        names, lines, k = {}, [], 0
        for n in self.order:
            a = [names[x.id] for x in n.args]
            if n.op == "const":
                names[n.id] = _f32_literal(n.value)
                continue
            if n.op in ("y", "p"):
                names[n.id] = f"{n.op}[{n.value}]"
                continue
            if n.op == "t":
                names[n.id] = "t"
                continue
            if n.op in _PY_OPS:
                expr = f"{a[0]} {_PY_OPS[n.op]} {a[1]}"
            elif n.op == "neg":
                expr = f"-{a[0]}"
            elif n.op in _CUDA_FN:
                expr = f"{_CUDA_FN[n.op]}({', '.join(a)})"
            elif n.op == "minimum":   # NaN-propagating, like torch/jnp
                expr = f"({a[0]} < {a[1]} || {a[0]} != {a[0]}) ? {a[0]} : {a[1]}"
            elif n.op == "maximum":
                expr = f"({a[0]} > {a[1]} || {a[0]} != {a[0]}) ? {a[0]} : {a[1]}"
            elif n.op == "where":
                expr = f"{a[0]} ? {a[1]} : {a[2]}"
            else:  # pragma: no cover - every traced op is listed above
                raise RhsTraceError(f"no CUDA form for op {n.op!r}")
            ctype = "bool" if n.op in _BOOL_OPS else "float"
            names[n.id] = f"v{k}"
            lines.append(f"  const {ctype} v{k} = {expr};")
            k += 1
        for s, o in enumerate(self.outputs):
            lines.append(f"  dy[{s}] = {names[o.id]};")
        return "\n".join(
            [f"__device__ __forceinline__ void {fn_name}(float t, "
             "const float* y, const float* p, float* dy) {",
             "  (void)t; (void)y; (void)p;"] + lines + ["}", ""])


@lru_cache(maxsize=64)
def trace_rhs(rhs, n_states: int, n_params: int) -> RhsProgram:
    """Trace ``rhs(t, y, ps)`` (already adapted, see :func:`adapt_rhs`)
    into an :class:`RhsProgram`, or raise :class:`RhsTraceError`."""
    g = _Graph()
    t = g.node("t")
    y = _Vec(g.node("y", value=i) for i in range(n_states))
    ps = [g.node("p", value=j) for j in range(n_params)]
    try:
        out = rhs(t, y, ps)
    except RhsTraceError:
        raise
    except Exception as e:
        raise RhsTraceError(
            f"the RHS could not be traced: {type(e).__name__}: {e}") from e
    if isinstance(out, (Expr, torch.Tensor)) or not hasattr(out, "__len__"):
        raise RhsTraceError("the RHS must return one value per state "
                            "(a list, tuple or stacked array)")
    out = [g.lift(v) for v in out]
    if len(out) != n_states:
        raise RhsTraceError(f"the RHS returned {len(out)} values for "
                            f"{n_states} states")
    name = getattr(rhs, "__qualname__", "rhs")
    inner = getattr(rhs, "__code__", None)
    if inner is not None and inner.co_freevars:
        # adapt_rhs closures: name the user's function, not the lambda
        for cell in rhs.__closure__ or ():
            fn = cell.cell_contents
            if callable(fn) and hasattr(fn, "__qualname__"):
                name = fn.__qualname__
                break
    return RhsProgram(g, out, n_states, n_params, name)


def torch_evaluator(rhs, n_states: int, n_params: int):
    """The DAG evaluator when the RHS traces; otherwise the RHS itself,
    run eagerly on torch tensors (CPU twins only)."""
    try:
        return trace_rhs(rhs, n_states, n_params).evaluate
    except RhsTraceError:
        return lambda t, y, ps: list(rhs(t, y, ps))
