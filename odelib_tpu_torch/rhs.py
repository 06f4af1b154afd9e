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

:meth:`RhsProgram.jacobian` differentiates the DAG in forward mode into a
program of its own (the Jacobian columns of the stiff stepper, in place
of the JAX kernel's ``jax.jvp`` calls), emitted in both forms;
:meth:`RhsProgram.diagonal` keeps its diagonal (a diffusion's d g_s / d y_s
for the Milstein step of the particle filter).

Array parameters (``pshapes``) reach the RHS as indexable proxies of one
leaf per theta slot: ``mu[0]``, ``A[i, j]``, ``A[i][j]``, iteration,
``len`` and elementwise arithmetic, the JAX kernel's stacked slot tiles;
linear algebra on them (``A @ y``) raises :class:`RhsTraceError`, as the
JAX package's ``rhs_supports_tiles`` refuses it. A forced RHS takes a
fourth argument, a dict of forcing leaves. Every node that depends on
forcings and constants only is folded into a leaf of its own, a forcing
*column* keyed by its expression (:func:`fold_host` evaluates it at a
concrete time in double, as the JAX kernel's Python floats fold at trace
time), so the kernels read each column from a table and never do that
arithmetic in float32.

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
import operator
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
        if args and all(a.op in ("u", "const") for a in args) and any(
                a.op == "u" for a in args):
            # forcings and constants only: one folded column leaf
            return self.node("u", value=(op,) + tuple(
                a.value if a.op == "u" else ("c", a.value.hex())
                for a in args))
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
        "indexing or iterating a scalar state or parameter")
    __matmul__ = __rmatmul__ = _no("the matrix product '@'")
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _no(
        "floor division and modulo")


class _Vec:
    """A traced array: the state vector, or an array parameter (one leaf
    per theta slot, row-major): ``v[i]``, ``A[i, j]``, ``A[i][j]``,
    slices of the first axis, unpacking, ``len`` and elementwise
    arithmetic, broadcast against scalars and arrays of its shape, as the
    JAX kernel's stacked slot tiles. Linear algebra raises."""

    def __init__(self, items, shape=None):
        self._items = list(items)
        self.shape = (len(self._items),) if shape is None else tuple(shape)

    @property
    def ndim(self):
        return len(self.shape)

    def _row(self, i):
        n = self.shape[0]
        if not -n <= i < n:
            raise RhsTraceError(f"index {i} is out of range for an array "
                                f"of shape {self.shape}")
        i %= n
        if len(self.shape) == 1:
            return self._items[i]
        w = len(self._items) // n
        return _Vec(self._items[i * w:(i + 1) * w], self.shape[1:])

    def __getitem__(self, i):
        if isinstance(i, tuple):
            out = self
            for k in i:
                if not isinstance(out, _Vec):
                    raise RhsTraceError(f"too many indices for an array of "
                                        f"shape {self.shape}")
                out = out[k]
            return out
        if isinstance(i, slice):
            rows = [self._row(k) for k in range(*i.indices(self.shape[0]))]
            if len(self.shape) == 1:
                return _Vec(rows)
            return _Vec([x for r in rows for x in r._items],
                        (len(rows),) + self.shape[1:])
        if isinstance(i, (int, np.integer)) and not isinstance(i, bool):
            return self._row(int(i))
        raise RhsTraceError("indexing a traced array with a "
                            f"{type(i).__name__} is not supported")

    def __iter__(self):
        return iter([self._row(i) for i in range(self.shape[0])])

    def __len__(self):
        return self.shape[0]

    def _map(self, fn, other=None, rev=False):
        if other is None:
            return _Vec([fn(a) for a in self._items], self.shape)
        if isinstance(other, _Vec):
            if other.shape != self.shape:
                raise RhsTraceError(f"arrays of shapes {self.shape} and "
                                    f"{other.shape} do not combine "
                                    "elementwise in the RHS tracer")
            pairs = zip(other._items, self._items) if rev \
                else zip(self._items, other._items)
        elif isinstance(other, (list, tuple)):
            return self._map(fn, _Vec(other), rev)
        else:
            pairs = ((other, a) for a in self._items) if rev \
                else ((a, other) for a in self._items)
        return _Vec([fn(a, b) for a, b in pairs], self.shape)

    def __add__(self, o): return self._map(lambda a, b: a + b, o)
    def __radd__(self, o): return self._map(lambda a, b: a + b, o, True)
    def __sub__(self, o): return self._map(lambda a, b: a - b, o)
    def __rsub__(self, o): return self._map(lambda a, b: a - b, o, True)
    def __mul__(self, o): return self._map(lambda a, b: a * b, o)
    def __rmul__(self, o): return self._map(lambda a, b: a * b, o, True)
    def __truediv__(self, o): return self._map(lambda a, b: a / b, o)
    def __rtruediv__(self, o): return self._map(lambda a, b: a / b, o, True)
    def __pow__(self, o): return self._map(lambda a, b: a ** b, o)
    def __rpow__(self, o): return self._map(lambda a, b: a ** b, o, True)
    def __neg__(self): return self._map(lambda a: -a)
    def __pos__(self): return self
    def __abs__(self): return self._map(abs)

    __array_ufunc__ = None
    __matmul__ = __rmatmul__ = _no("the matrix product '@' (linear algebra "
                                   "on an array parameter)")
    __bool__ = _no("Python control flow on a traced array")

    @property
    def T(self):
        raise RhsTraceError("transposing an array parameter (linear "
                            "algebra) is not supported by the RHS tracer")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise RhsTraceError(f"the array method or attribute {name!r} is not "
                            "supported by the RHS tracer (only indexing, "
                            "iteration, len and elementwise arithmetic)")


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
            if isinstance(x, _Vec):
                return x._map(lambda a: f(self, a))
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
            if isinstance(a, _Vec):
                return a._map(lambda p, q: f(self, p, q), b)
            if isinstance(b, _Vec):
                return b._map(lambda p, q: f(self, q, p), a)
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
        vec = next((v for v in (c, a, b) if isinstance(v, _Vec)), None)
        if vec is not None:
            parts = [v._items if isinstance(v, _Vec) else
                     [v] * len(vec._items) for v in (c, a, b)]
            if any(len(p) != len(vec._items) for p in parts):
                raise RhsTraceError("np.where on arrays of different shapes "
                                    "is not supported by the RHS tracer")
            return _Vec([self.where(*abc) for abc in zip(*parts)], vec.shape)
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
        if isinstance(seq, _Vec) and seq.ndim > 1:
            return seq
        if isinstance(seq, (list, tuple, _Vec)):
            return self.stack(seq)
        return seq if isinstance(seq, Expr) else torch.as_tensor(seq)

    asarray = array

    def dot(self, a, b):
        if _first_expr(a, b) is not None:
            raise RhsTraceError(
                f"{self._name}.dot is not supported by the RHS tracer "
                f"(supported: {', '.join(_SUPPORTED)})")
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.ndim <= 2 and b.ndim <= 2:
            return torch.matmul(a, b) if a.ndim and b.ndim else a * b
        return torch.tensordot(a, b, dims=([-1], [-2 if b.ndim > 1 else 0]))

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
    """The user's RHS as ``g(t, y, ps[, u])`` with rebound globals; ``u``,
    a forced model's dict of forcing values, is passed through. The
    adapter records whether the user's function takes it
    (:func:`takes_forcings`)."""
    if style == "auto":
        style = infer_style(f)
    rf = rebind_globals(f)
    if style == "reference":
        def g(t, y, ps, *rest):
            return rf(y, t, ps, *rest)
    else:
        def g(t, y, ps, *rest):
            return rf(t, y, ps, *rest)
    try:
        g._odelib_takes_u = len(inspect.signature(f).parameters) >= 4
    except (TypeError, ValueError):
        g._odelib_takes_u = False
    return g


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


def _tangent(g, n, tan, one):
    """Forward-mode rule of node ``n``: its tangent from its operands'
    (``tan``: node id -> tangent node, absent where the tangent is zero),
    or None where it is zero. ``one`` is the constant 1.0 node, the seed
    tangent, folded out of products."""
    op, a = n.op, n.args
    ta = [tan.get(x.id) for x in a]
    if op in ("const", "t", "p", "y", "u") or op in _BOOL_OPS:
        return None        # leaves are seeded by the caller; tests: 0
    if all(d is None for d in ta):
        return None
    zero = g.lift(0.0)

    def mul(d, x):                  # d * x, a unit tangent folded
        return x if d is one else g.node("mul", (d, x))

    def z(d):
        return zero if d is None else d
    if op == "add":
        if ta[0] is None or ta[1] is None:
            return ta[0] if ta[1] is None else ta[1]
        return g.node("add", (ta[0], ta[1]))
    if op == "sub":
        if ta[1] is None:
            return ta[0]
        if ta[0] is None:
            return g.node("neg", (ta[1],))
        return g.node("sub", (ta[0], ta[1]))
    if op == "neg":
        return g.node("neg", (ta[0],))
    if op == "mul":
        terms = [mul(d, x) for d, x in ((ta[0], a[1]), (ta[1], a[0]))
                 if d is not None]
        return terms[0] if len(terms) == 1 else g.node("add", tuple(terms))
    if op == "div":                 # (da - (a / b) db) / b
        if ta[1] is None:
            return g.node("div", (ta[0], a[1]))
        q = mul(ta[1], n)
        num = g.node("neg", (q,)) if ta[0] is None \
            else g.node("sub", (ta[0], q))
        return g.node("div", (num, a[1]))
    if op == "exp":
        return mul(ta[0], n)
    if op == "log":
        return g.node("div", (ta[0], a[0]))
    if op == "sqrt":
        return g.node("div", (g.node("mul", (ta[0], g.lift(0.5))), n))
    if op == "pow":                 # b a^(b - 1) da + log(a) a^b db
        terms = []
        if ta[0] is not None:
            if a[1].op == "const":
                dpow = g.node("mul", (a[1], g.node(
                    "pow", (a[0], g.lift(a[1].value - 1.0)))))
            else:
                dpow = g.node("mul", (a[1], g.node(
                    "pow", (a[0], g.node("sub", (a[1], one))))))
            terms.append(mul(ta[0], dpow))
        if ta[1] is not None:
            terms.append(mul(ta[1], g.node("mul", (g.node("log", (a[0],)),
                                                   n))))
        return terms[0] if len(terms) == 1 else g.node("add", tuple(terms))
    if op == "abs":                 # JAX's rule: da where a >= 0, else -da
        return g.node("where", (g.node("ge", (a[0], zero)), ta[0],
                                g.node("neg", (ta[0],))))
    if op in ("minimum", "maximum"):
        # the operand taken, half of each at a tie (JAX's balanced rule)
        cmp = "lt" if op == "minimum" else "gt"
        half = g.node("mul", (g.node("add", (z(ta[0]), z(ta[1]))),
                              g.lift(0.5)))
        return g.node("where", (
            g.node(cmp, (a[0], a[1])), z(ta[0]),
            g.node("where", (g.node(cmp, (a[1], a[0])), z(ta[1]), half))))
    if op == "where":
        return g.node("where", (a[0], z(ta[1]), z(ta[2])))
    raise RhsTraceError(f"no derivative rule for the RHS operation {op!r}")


def _is_bool_column(key) -> bool:
    return key[0] in _BOOL_OPS


class RhsProgram:
    """A traced RHS: ``n_states`` outputs over states, parameters (one
    leaf per theta slot), t and the forcing columns (:attr:`columns`)."""

    def __init__(self, graph, outputs, n_states, n_params, name="rhs"):
        self._graph = graph
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

    @property
    def columns(self):
        """The forcing columns this program reads, in node order: each a
        folded expression key over the raw forcings (:func:`fold_host`)."""
        return tuple(n.value for n in self.order if n.op == "u")

    def evaluate(self, t, y, ps, u=None):
        """Torch evaluation: ``y`` is a sequence of S tensors, ``ps`` of P
        per-slot tensors (or scalars), ``u`` maps each forcing column
        (:attr:`columns`) to its value (a tensor or float; a boolean
        column's as 1.0 or 0.0); returns S tensors of the broadcast
        shape."""
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
            elif n.op == "u":
                v = torch.as_tensor(u[n.value], dtype=ref.dtype,
                                    device=ref.device)
                if _is_bool_column(n.value):
                    v = v != 0
            else:
                v = _TORCH_FN[n.op](*(val[a.id] for a in n.args))
            val[n.id] = v
        shape = torch.broadcast_shapes(
            *(v.shape for v in y),
            *(val[n.id].shape for n in self.order if n.op in ("p", "u")))
        return [torch.broadcast_to(val[o.id], shape) for o in self.outputs]

    def jacobian(self) -> "RhsProgram":
        """The Jacobian of the RHS in the states, d f_i / d y_j, as a
        program of S * S outputs in row-major order (output i S + j), by
        forward-mode differentiation of the DAG: one tangent sweep per
        state j (the JAX kernel's ``jax.jvp`` columns), zero tangents
        folded so that column j touches only the nodes that depend on
        y_j. Its :meth:`evaluate` and :meth:`cuda_function` run the same
        expressions in the same order. Cached; an operation without a
        rule raises :class:`RhsTraceError`."""
        jac = getattr(self, "_jacobian", None)
        if jac is not None:
            return jac
        g, S = self._graph, self.n_states
        one = g.lift(1.0)
        cols = []
        for j in range(S):
            tan = {}
            for n in self.order:
                d = one if n.op == "y" and n.value == j \
                    else _tangent(g, n, tan, one)
                if d is not None:
                    tan[n.id] = d
            cols.append([tan.get(o.id, g.lift(0.0)) for o in self.outputs])
        self._jacobian = RhsProgram(
            g, [cols[j][i] for i in range(S) for j in range(S)], S,
            self.n_params, f"jacobian of {self.name}")
        return self._jacobian

    def diagonal(self) -> "RhsProgram":
        """The Jacobian's diagonal, d f_s / d y_s for s < S, as a program
        of S outputs: the diagonal entries of :meth:`jacobian`'s tangent
        sweeps (the JAX kernel's S one-hot ``jax.jvp`` columns, each
        keeping its own state's entry; for a diffusion g, the Milstein
        step's d g_s / d y_s). Only the nodes those entries reach are
        evaluated or emitted. An operation without a rule raises
        :class:`RhsTraceError`."""
        diag = getattr(self, "_diagonal", None)
        if diag is None:
            jac, S = self.jacobian(), self.n_states
            diag = self._diagonal = RhsProgram(
                self._graph, [jac.outputs[s * S + s] for s in range(S)], S,
                self.n_params, f"diagonal of the jacobian of {self.name}")
        return diag

    def cuda_source(self, columns=None) -> str:
        """The RHS as ``__device__ void rhs(float t, const float* y,
        const float* p, const float* u, float* dy)`` after the ``ODE_S``/
        ``ODE_P``/``ODE_F`` defines, one SSA statement per node; ``u``
        holds the forcing ``columns`` (default :attr:`columns`)."""
        columns = self.columns if columns is None else tuple(columns)
        return "\n".join([f"// traced from {self.name}",
                          f"#define ODE_S {self.n_states}",
                          f"#define ODE_P {self.n_params}",
                          f"#define ODE_F {len(columns)}",
                          self.cuda_function("rhs", columns)])

    def cuda_function(self, fn_name: str, columns=None) -> str:
        """The traced function as ``__device__ void <fn_name>(float t,
        const float* y, const float* p, const float* u, float* dy)``, column
        ``columns[k]`` read from ``u[k]`` (default :attr:`columns`)."""
        columns = self.columns if columns is None else tuple(columns)
        col = {c: k for k, c in enumerate(columns)}
        names, lines, k = {}, [], 0
        for n in self.order:
            a = [names[x.id] for x in n.args]
            if n.op == "const":
                names[n.id] = _f32_literal(n.value)
                continue
            if n.op in ("y", "p"):
                names[n.id] = f"{n.op}[{n.value}]"
                continue
            if n.op == "u":
                names[n.id] = f"(u[{col[n.value]}] != 0.0f)" \
                    if _is_bool_column(n.value) else f"u[{col[n.value]}]"
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
             "const float* y, const float* p, const float* u, float* dy) {",
             "  (void)t; (void)y; (void)p; (void)u;"] + lines + ["}", ""])


def pshapes_of(params):
    """Parameter shapes from a count of scalar parameters or from shapes
    (``()`` for a scalar), as a hashable tuple."""
    if isinstance(params, (int, np.integer)):
        return tuple(() for _ in range(int(params)))
    return tuple(tuple(int(d) for d in shp) for shp in params)


def forcing_names(forcings) -> tuple:
    """The names of a spec's forcings: from its normalised tables
    (``(name, times, values, mode)`` entries) or from names."""
    return tuple(f[0] if isinstance(f, tuple) else str(f)
                 for f in forcings or ())


def takes_forcings(fn) -> bool:
    """Whether ``fn`` takes the forcing dict as a fourth argument: an
    adapted function says so for the user's (:func:`adapt_rhs`), another
    by its arity."""
    flag = getattr(fn, "_odelib_takes_u", None)
    if flag is not None:
        return bool(flag)
    try:
        return len(inspect.signature(fn).parameters) >= 4
    except (TypeError, ValueError):
        return False


def _call(fn, t, y, ps, u):
    return fn(t, y, ps) if u is None else fn(t, y, ps, u)


def trace_rhs(rhs, n_states: int, params, forcings=()) -> RhsProgram:
    """Trace ``rhs(t, y, ps[, u])`` (already adapted, see
    :func:`adapt_rhs`) into an :class:`RhsProgram`, or raise
    :class:`RhsTraceError`. ``params`` is the number of scalar parameters
    or the parameters' shapes (``pshapes``: an array parameter is one
    leaf per slot, :class:`_Vec`); with ``forcings`` (names, or a spec's
    tables) the function gets a dict of forcing leaves as its fourth
    argument. Cached on the function, the shapes and the forcing names."""
    return _trace(rhs, int(n_states), pshapes_of(params),
                  forcing_names(forcings))


@lru_cache(maxsize=64)
def _trace(rhs, n_states, pshapes, names) -> RhsProgram:
    g = _Graph()
    t = g.node("t")
    y = _Vec(g.node("y", value=i) for i in range(n_states))
    ps, off = [], 0
    for shp in pshapes:
        n = int(np.prod(shp)) if shp else 1
        leaves = [g.node("p", value=off + k) for k in range(n)]
        ps.append(_Vec(leaves, shp) if shp else leaves[0])
        off += n
    u = {nm: g.node("u", value=("f", nm)) for nm in names} if names else None
    try:
        out = _call(rhs, t, y, ps, u)
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
    return RhsProgram(g, out, n_states, off, name)


def forcing_columns(program: RhsProgram, diffusion=None) -> tuple:
    """Every forcing column the kernels of a model may read, in a fixed
    order: the RHS's, its Jacobian's (the Kvaerno3 step), the diffusion's
    and its diagonal's (the particle filter, Milstein); () unforced. The
    plan's forcing table holds one value per column and stage time."""
    cols = []
    progs = [program] + ([program.jacobian()] if program.columns else [])
    if diffusion is not None:
        progs += [diffusion] + ([diffusion.diagonal()]
                                if diffusion.columns else [])
    for p in progs:
        cols += [c for c in p.columns if c not in cols]
    return tuple(cols)


_PY_CMP = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
           "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}
_FOLD_F32 = {"exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
             "abs": torch.abs}


def column_text(key) -> str:
    """A forcing column as the expression it folds, over forcing names."""
    op = key[0]
    if op == "f":
        return key[1]
    if op == "c":
        return repr(float.fromhex(key[1]))
    args = [column_text(k) for k in key[1:]]
    if op in _PY_OPS:
        return f"({args[0]} {_PY_OPS[op]} {args[1]})"
    if op == "neg":
        return f"(-{args[0]})"
    return f"{op}({', '.join(args)})"


def fold_host(key, raw) -> float:
    """A forcing column's value from the raw forcing values ``raw`` (by
    name, :func:`~odelib_tpu_torch.model.eval_forcings`) at one concrete
    time, as the JAX kernel folds it at trace
    time: Python's arithmetic and comparisons in double (a comparison as
    1.0 or 0.0), ``exp``/``log``/``sqrt``/``abs`` in float32, as ``jnp``
    computes them on a Python scalar."""
    op = key[0]
    if op == "f":
        return float(raw[key[1]])
    if op == "c":
        return float.fromhex(key[1])
    a = [fold_host(k, raw) for k in key[1:]]
    if op in _FOLD_F32:
        return float(_FOLD_F32[op](torch.tensor(a[0], dtype=torch.float32)))
    with np.errstate(all="ignore"):
        x = [np.float64(v) for v in a]
        if op == "where":
            return float(x[1] if x[0] != 0 else x[2])
        if op == "minimum":
            return float(np.minimum(x[0], x[1]))
        if op == "maximum":
            return float(np.maximum(x[0], x[1]))
        if op == "neg":
            return float(-x[0])
        if op in _BOOL_OPS:
            return 1.0 if _PY_CMP[op](x[0], x[1]) else 0.0
        return float({"add": np.add, "sub": np.subtract,
                      "mul": np.multiply, "div": np.divide,
                      "pow": np.power}[op](x[0], x[1]))


def fold_torch(key, raw):
    """A forcing column's value from raw forcing tensors ``raw`` (by name,
    at tensor times, :func:`~odelib_tpu_torch.model.eval_forcings`), every
    operation in their dtype: the adaptive and fixed torch solvers'."""
    op = key[0]
    if op == "f":
        return raw[key[1]]
    ref = next(iter(raw.values()))
    if op == "c":
        return torch.tensor(float.fromhex(key[1]), dtype=ref.dtype,
                            device=ref.device)
    a = [fold_torch(k, raw) for k in key[1:]]
    if op == "where":
        return torch.where(a[0] != 0, a[1], a[2])
    v = _TORCH_FN[op](*a)
    return v.to(ref.dtype) if op in _BOOL_OPS else v


def assemble_params(pshapes, ps):
    """Per-parameter values from per-slot values ``ps``: an array
    parameter's slots stacked to ``shape + batch`` (the JAX kernel's
    ``_assemble_params``), a scalar's slot as it is."""
    out, off = [], 0
    for shp in pshapes:
        if shp:
            n = int(np.prod(shp))
            st = torch.stack([torch.as_tensor(v) for v in ps[off:off + n]])
            out.append(st.reshape(tuple(shp) + st.shape[1:]))
            off += n
        else:
            out.append(ps[off])
            off += 1
    return out


def eager_function(fn, params, forcings=None):
    """``fn`` run eagerly on torch values with per-slot ``ps``: array
    parameters assembled, and a forced function given the raw forcing dict
    at ``t`` (Python floats at a float time, tensors at tensor times)."""
    pshapes = pshapes_of(params)
    arrays = any(pshapes)

    def run(t, y, ps, u=None):
        if arrays:
            ps = assemble_params(pshapes, ps)
        raw = None
        if forcings:
            from .model import eval_forcings
            raw = eval_forcings(forcings, t)
        return list(_call(fn, t, y, ps, raw))
    return run


def lane_function(fn, params, forcings=None):
    """``f(t, y (S, N), ps) -> (S, N)``: ``fn`` called once per lane
    through ``torch.func.vmap``, as the JAX package ``vmap``s a solve over
    chains: each call sees one lane's states (S,), its parameters (an
    array parameter with its shape, so linear algebra such as ``A @ y``
    runs as written) and, for a forced ``fn``, the forcing dict at its
    time. ``ps`` are the per-slot values (N,) or scalars. Python control
    flow on a value cannot run under ``vmap`` and raises."""
    pshapes = pshapes_of(params)
    one = _lane_call(fn, pshapes, forcings)
    batched = torch.func.vmap(one)

    def run(t, y, ps):
        tt, theta = _lane_args(t, y, ps)
        return batched(tt, y.t(), theta).t()
    return run


def vmap_refused(e: BaseException) -> bool:
    """Whether ``e`` is ``torch.func.vmap`` refusing a function it cannot
    batch (Python control flow on a value, ``.item()``, an unbatchable
    operator), as opposed to an error of the function itself."""
    return isinstance(e, RuntimeError) and str(e).startswith("vmap:")


def lane_jacobian(fn, params, forcings=None):
    """``jac(t, y (S, N), ps) -> (S, S, N)``, d f_i / d y_j of
    :func:`lane_function`'s ``fn`` by ``torch.func.jacfwd`` on each lane
    (the JAX package's ``jax.jacfwd`` of its vmapped solve)."""
    one = _lane_call(fn, pshapes_of(params), forcings)
    batched = torch.func.vmap(torch.func.jacfwd(one, argnums=1))

    def jac(t, y, ps):
        tt, theta = _lane_args(t, y, ps)
        return batched(tt, y.t(), theta).permute(1, 2, 0)
    return jac


def _lane_args(t, y, ps):
    """The lanes' times (N,) and flat parameters (N, P)."""
    N = y.shape[1]
    tt = torch.as_tensor(t, dtype=y.dtype, device=y.device).expand(N)
    theta = torch.stack([torch.as_tensor(p, dtype=y.dtype,
                                         device=y.device).expand(N)
                         for p in ps], dim=-1) if len(ps) else \
        y.new_zeros((N, 0))
    return tt, theta


def _lane_call(fn, pshapes, forcings):
    """One lane of :func:`lane_function`: ``(t, y (S,), theta (P,)) ->
    (S,)``."""
    def one(t, y, theta):
        ps, off = [], 0
        for shp in pshapes:
            n = int(np.prod(shp)) if shp else 1
            ps.append(theta[off:off + n].reshape(shp) if shp else theta[off])
            off += n
        raw = None
        if forcings:
            from .model import eval_forcings
            raw = eval_forcings(forcings, t)
        out = _call(fn, t, y, ps, raw)
        if isinstance(out, torch.Tensor):
            return out.to(y.dtype)
        return _eager_stack(list(out)).to(y.dtype)
    return one


def torch_evaluator(rhs, n_states: int, params, forcings=None):
    """``f(t, y, ps, u=None)``: the DAG evaluator when the RHS traces;
    otherwise the RHS itself, run eagerly on torch tensors (CPU twins
    only; :func:`eager_function`, which computes the forcings itself)."""
    try:
        return trace_rhs(rhs, n_states, params, forcings).evaluate
    except RhsTraceError:
        return eager_function(rhs, params, forcings)


def jacobian_evaluator(rhs, n_states: int, params, forcings=None):
    """``jac(t, y, ps, u=None)``: the S * S Jacobian entries d f_i / d y_j
    (row-major) of a traced RHS (:meth:`RhsProgram.jacobian`); for an RHS
    that does not trace, the forward-mode columns of the eager RHS
    (:func:`jvp_columns`, CPU twins only)."""
    try:
        return trace_rhs(rhs, n_states, params, forcings).jacobian().evaluate
    except RhsTraceError:
        f = eager_function(rhs, params, forcings)

        def jac(t, y, ps, u=None):
            cols = jvp_columns(lambda yy: torch.stack(f(t, list(yy), ps)),
                               torch.stack(list(y)))
            return [cols[j][i] for i in range(n_states)
                    for j in range(n_states)]
        return jac


def diagonal_evaluator(fn, n_states: int, params, forcings=None):
    """``diag(t, y, ps, u=None)``: the S entries d f_s / d y_s of a traced
    function's Jacobian (:meth:`RhsProgram.diagonal`); for one that does
    not trace, the diagonal of the eager function's forward-mode columns
    (:func:`jvp_columns`, CPU twins only)."""
    try:
        return trace_rhs(fn, n_states, params, forcings).diagonal().evaluate
    except RhsTraceError:
        f = eager_function(fn, params, forcings)

        def diag(t, y, ps, u=None):
            cols = jvp_columns(lambda yy: torch.stack(f(t, list(yy), ps)),
                               torch.stack(list(y)))
            return [cols[s][s] for s in range(n_states)]
        return diag


def jvp_columns(f, y):
    """The Jacobian columns of a state map ``f`` at ``y`` (S, ...): column
    j is the forward-mode derivative along the one-hot tangent of state j
    on every lane, as the JAX package takes them (``jax.jvp``); returns S
    tensors of ``f(y)``'s shape."""
    cols = []
    for j in range(y.shape[0]):
        e = torch.zeros_like(y)
        e[j] = 1.0
        cols.append(torch.func.jvp(f, (y,), (e,))[1])
    return cols
