"""Core VectorFunction layer: composable differentiable functions over jnp.

JAX replacement for the reference's expression-template AD engine
(`src/VectorFunctions/ComputableBase.h`, `DenseFunctionBase.h`,
`CommonFunctions/*`): instead of CRTP nodes with hand-written first/second
order chain rules, a VectorFunction here is a traceable closure
``fn: jnp (IRows,) -> jnp (ORows,)``.  Composition is Python closure
composition; derivatives (jacobian, adjoint gradient J^T*lam, adjoint hessian
grad^2 lam^T f) come from jax AD and match the reference's
``computeall`` interface (`asset_asrl/test/test_VectorFunctions/__init__.py:32`).

Everything built from these functions is vmappable and jittable, which is what
the solver layer exploits: one batched call per function *kind* replaces the
reference's per-4-application AVX "SuperScalar" loop
(`DenseFunctionBase.h:1171-1211`).
"""

from __future__ import annotations

import functools
import math
import numbers

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_DTYPE

__all__ = [
    "VectorFunction",
    "ScalarFunction",
    "Arguments",
    "ConditionalFunction",
    "Constant",
    "as_function",
    "stack",
]


def _is_numericlike(v):
    return isinstance(v, (numbers.Number, np.ndarray, jnp.ndarray, list, tuple, range))


# Trace-time common-subexpression cache.  Expression composition builds
# Python closure trees; a subexpression reused k times (e.g. Mach number
# feeding four aero tables in MinimumTimeToClimb) would be re-traced k times
# per enclosing node — exponential in expression depth (the reference's
# expression templates share nodes by reference and don't pay this;
# `DenseFunctionBase.h:111-150`).  Memoizing each node's traced output per
# input object during one root trace turns the tree back into the DAG the
# user wrote.  The cache lives only for the duration of the outermost node
# call (depth counter), so no jax tracers leak across traces; cached values
# keep their input alive, so id() reuse cannot alias keys.  THREAD-LOCAL:
# Jet ensembles trace problems concurrently from a thread pool (reference
# `Jet.h:92-151`), so a shared depth/cache would corrupt across threads.
import threading as _threading

_TRACE_TLS = _threading.local()


def _trace_state():
    st = getattr(_TRACE_TLS, "state", None)
    if st is None:
        st = {"depth": 0, "cache": None}
        _TRACE_TLS.state = st
    return st


def _memoized(node, raw):
    def wrapped(x):
        st = _trace_state()
        root = st["depth"] == 0
        if root:
            st["cache"] = {}
        st["depth"] += 1
        try:
            cache = st["cache"]
            key = (id(node), id(x))
            hit = cache.get(key)
            if hit is not None and hit[0] is x:
                return hit[1]
            out = raw(x)
            cache[key] = (x, out)
            return out
        finally:
            st["depth"] -= 1
            if root:
                st["cache"] = None
    return wrapped


def _const_array(v):
    a = jnp.atleast_1d(jnp.asarray(v, dtype=DEFAULT_DTYPE))
    if a.ndim != 1:
        a = a.ravel()
    return a


def as_function(v, irows=None):
    """Promote a numeric value to a Constant VectorFunction of input size irows."""
    if isinstance(v, VectorFunction):
        return v
    if irows is None:
        raise ValueError(
            "Cannot promote a numeric constant to a VectorFunction without "
            "knowing the input size; combine it with at least one function.")
    a = _const_array(v)
    return VectorFunction(lambda x, a=a: a, irows, int(a.shape[0]), name="Constant")


class VectorFunction:
    """A differentiable map R^IRows -> R^ORows built from a jnp closure."""

    # numpy must DEFER to our reflected operators: without these,
    # `np_array - expr` broadcasts element-wise over the expression and
    # yields an object ndarray instead of calling __rsub__.
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, fn, irows, orows, name="VectorFunction"):
        self._fn = _memoized(self, fn)
        self._ir = int(irows)
        self._orr = int(orows)
        self._name = name
        self._jits = {}

    # ------------------------------------------------------------------ sizes
    def IRows(self):
        return self._ir

    def ORows(self):
        return self._orr

    @property
    def name(self):
        return self._name

    def __repr__(self):
        return f"<{self._name}: R^{self._ir} -> R^{self._orr}>"

    # ------------------------------------------------------------- tracing
    def trace(self, x):
        """Apply the underlying closure to a traced jnp vector of size IRows."""
        out = self._fn(x)
        out = jnp.atleast_1d(out)
        return out

    # ------------------------------------------------------------- numerics
    def _jit(self, key):
        f = self._jits.get(key)
        if f is None:
            if key == "compute":
                f = jax.jit(self.trace)
            elif key == "jacobian":
                if self._ir <= 2 * self._orr:
                    f = jax.jit(jax.jacfwd(self.trace))
                else:
                    # reverse mode for wide inputs; functions containing
                    # lax.while_loop (root-finders, propagators) only
                    # support forward mode — fall back per call
                    rev = jax.jit(jax.jacrev(self.trace))
                    fwd = jax.jit(jax.jacfwd(self.trace))

                    def f(x, _rev=rev, _fwd=fwd):
                        try:
                            return _rev(x)
                        except ValueError:
                            return _fwd(x)
            elif key == "adjointgradient":
                def agrad(x, l):
                    _, vjp = jax.vjp(self.trace, x)
                    return vjp(l)[0]
                f = jax.jit(agrad)
            elif key == "adjointhessian":
                def ahess(x, l):
                    return jax.jacfwd(
                        lambda y: jax.vjp(self.trace, y)[1](l)[0])(x)
                f = jax.jit(ahess)
            elif key == "computeall":
                def call(x, l):
                    fx = self.trace(x)
                    jx = jax.jacfwd(self.trace)(x)
                    def agrad(y):
                        _, vjp = jax.vjp(self.trace, y)
                        return vjp(l)[0]
                    gx = agrad(x)
                    hx = jax.jacfwd(agrad)(x)
                    return fx, jx, gx, hx
                f = jax.jit(call)
            else:  # pragma: no cover
                raise KeyError(key)
            self._jits[key] = f
        return f

    def _x(self, x):
        x = jnp.asarray(x, dtype=DEFAULT_DTYPE).ravel()
        if x.shape[0] != self._ir:
            raise ValueError(
                f"{self!r} expected input of size {self._ir}, got {x.shape[0]}")
        return x

    def _l(self, l):
        l = jnp.asarray(l, dtype=DEFAULT_DTYPE).ravel()
        if l.shape[0] != self._orr:
            raise ValueError(
                f"{self!r} expected multiplier of size {self._orr}, got {l.shape[0]}")
        return l

    def compute(self, x):
        return np.asarray(self._jit("compute")(self._x(x)))

    def jacobian(self, x):
        return np.asarray(self._jit("jacobian")(self._x(x)))

    def adjointgradient(self, x, l):
        return np.asarray(self._jit("adjointgradient")(self._x(x), self._l(l)))

    def adjointhessian(self, x, l):
        return np.asarray(self._jit("adjointhessian")(self._x(x), self._l(l)))

    def computeall(self, x, l):
        fx, jx, gx, hx = self._jit("computeall")(self._x(x), self._l(l))
        return (np.asarray(fx), np.asarray(jx), np.asarray(gx), np.asarray(hx))

    # ------------------------------------------------------------ composition
    def eval(self, other, idx=None):
        """Composition self(other(x)); reference: NestedFunction.h chain rule.

        eval(n, [i0, i1, ...]) composes with an index selection from R^n
        (reference `f.eval(8, [0,2,6])` idiom)."""
        if idx is not None:
            n = int(other)
            sel = jnp.asarray(np.asarray(list(idx), dtype=np.int32))
            if len(sel) != self._ir:
                raise ValueError("eval(n, idx): len(idx) != IRows")
            f = self._fn
            return VectorFunction(lambda x: f(jnp.atleast_1d(x)[sel]),
                                  n, self._orr, name=f"{self._name}∘sel")
        other = _stack_arg(other)
        if other.ORows() != self._ir:
            raise ValueError(
                f"Cannot compose {self!r} with {other!r}: size mismatch")
        f, g = self._fn, other._fn
        return VectorFunction(lambda x: f(jnp.atleast_1d(g(x))),
                              other.IRows(), self._orr,
                              name=f"{self._name}∘{other._name}")

    def __call__(self, *args):
        if len(args) == 1 and _is_numericlike(args[0]) \
                and not isinstance(args[0], VectorFunction):
            return self.compute(args[0])
        if len(args) == 1 and isinstance(args[0], VectorFunction):
            return self.eval(args[0])
        # multiple args: stack them then compose
        return self.eval(stack(list(args)))

    # ---------------------------------------------------------- sub-selection
    def coeff(self, i):
        i = int(i)
        f = self._fn
        return VectorFunction(lambda x: jnp.atleast_1d(f(x))[i:i + 1],
                              self._ir, 1, name=f"{self._name}[{i}]")

    def __getitem__(self, i):
        if isinstance(i, slice):
            idx = range(*i.indices(self._orr))
            start, stop, step = i.indices(self._orr)
            if step == 1:
                return self.segment(start, stop - start)
            f = self._fn
            idxa = jnp.asarray(list(idx), dtype=jnp.int32)
            return VectorFunction(lambda x: jnp.atleast_1d(f(x))[idxa],
                                  self._ir, len(idxa), name=f"{self._name}[slice]")
        return self.coeff(i)

    def segment(self, start, size):
        start, size = int(start), int(size)
        if start < 0 or start + size > self._orr:
            raise ValueError(f"segment({start},{size}) out of range for {self!r}")
        f = self._fn
        return VectorFunction(lambda x: jnp.atleast_1d(f(x))[start:start + size],
                              self._ir, size, name=f"{self._name}.segment")

    def head(self, size):
        return self.segment(0, size)

    def tail(self, size):
        return self.segment(self._orr - size, size)

    # fixed-size conveniences (reference Segment2/Segment3 aliases)
    def head2(self):
        return self.segment(0, 2)

    def head3(self):
        return self.segment(0, 3)

    def tail2(self):
        return self.segment(self._orr - 2, 2)

    def tail3(self):
        return self.segment(self._orr - 3, 3)

    def segment2(self, start):
        return self.segment(start, 2)

    def segment3(self, start):
        return self.segment(start, 3)

    def tolist(self, pairs=None):
        """List of scalar element functions; with pairs, list of segments.

        Mirrors reference Arguments.tolist() / tolist([(start,size),...]).
        """
        if pairs is None:
            return [self.coeff(i) for i in range(self._orr)]
        return [self.segment(s, n) for (s, n) in pairs]

    # -------------------------------------------------------------- arithmetic
    def _binary(self, other, op, opname, reverse=False):
        if _is_numericlike(other) and not isinstance(other, VectorFunction):
            a = _const_array(other)
            f = self._fn
            if reverse:
                out = np.broadcast_shapes((int(a.shape[0]),), (self._orr,))[0]
                return VectorFunction(
                    lambda x: jnp.atleast_1d(op(a, jnp.atleast_1d(f(x)))),
                    self._ir, out, name=opname)
            out = np.broadcast_shapes((self._orr,), (int(a.shape[0]),))[0]
            return VectorFunction(
                lambda x: jnp.atleast_1d(op(jnp.atleast_1d(f(x)), a)),
                self._ir, out, name=opname)
        if isinstance(other, VectorFunction):
            if other.IRows() != self._ir:
                raise ValueError(
                    f"Cannot combine {self!r} and {other!r}: input sizes differ")
            out = np.broadcast_shapes((self._orr,), (other.ORows(),))[0]
            f, g = self._fn, other._fn
            if reverse:
                return VectorFunction(
                    lambda x: jnp.atleast_1d(
                        op(jnp.atleast_1d(g(x)), jnp.atleast_1d(f(x)))),
                    self._ir, out, name=opname)
            return VectorFunction(
                lambda x: jnp.atleast_1d(
                    op(jnp.atleast_1d(f(x)), jnp.atleast_1d(g(x)))),
                self._ir, out, name=opname)
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, jnp.add, "add")

    def __radd__(self, other):
        return self._binary(other, jnp.add, "add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, jnp.subtract, "sub")

    def __rsub__(self, other):
        return self._binary(other, jnp.subtract, "sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, jnp.multiply, "mul")

    def __rmul__(self, other):
        return self._binary(other, jnp.multiply, "mul", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, jnp.divide, "div")

    def __rtruediv__(self, other):
        return self._binary(other, jnp.divide, "div", reverse=True)

    def __pow__(self, p):
        if isinstance(p, VectorFunction):
            return self._binary(p, jnp.power, "pow")
        f = self._fn
        if float(p) == int(p):
            # integral exponents lower to lax.integer_pow, whose derivative
            # rules are pure polynomials.  General pow differentiates
            # through x**(p-k) terms that a backend may evaluate as
            # exp((p-k)·log x) — NaN second derivatives at x == 0, which
            # bites any initial guess with exact zeros (e.g. zero controls).
            ip = int(p)
            return VectorFunction(lambda x: jnp.atleast_1d(f(x)) ** ip,
                                  self._ir, self._orr, name="pow")
        p = float(p)
        return VectorFunction(lambda x: jnp.power(jnp.atleast_1d(f(x)), p),
                              self._ir, self._orr, name="pow")

    def __neg__(self):
        f = self._fn
        return VectorFunction(lambda x: -jnp.atleast_1d(f(x)),
                              self._ir, self._orr, name="neg")

    def __abs__(self):
        f = self._fn
        return VectorFunction(lambda x: jnp.abs(jnp.atleast_1d(f(x))),
                              self._ir, self._orr, name="abs")

    # ------------------------------------------------------------- reductions
    def sum(self):
        f = self._fn
        return VectorFunction(
            lambda x: jnp.sum(jnp.atleast_1d(f(x)), keepdims=True),
            self._ir, 1, name="sum")

    def dot(self, other):
        other = _stack_arg(other, irows=self._ir)
        if other.ORows() != self._orr:
            raise ValueError("dot: output sizes differ")
        f, g = self._fn, other._fn
        return VectorFunction(
            lambda x: jnp.sum(jnp.atleast_1d(f(x)) * jnp.atleast_1d(g(x)),
                              keepdims=True),
            self._ir, 1, name="dot")

    def cross(self, other):
        other = _stack_arg(other, irows=self._ir)
        if self._orr != 3 or other.ORows() != 3:
            raise ValueError("cross requires 3-vectors")
        f, g = self._fn, other._fn
        return VectorFunction(lambda x: jnp.cross(f(x), g(x)),
                              self._ir, 3, name="cross")

    def cwiseProduct(self, other):
        """Elementwise product with a same-size function or constant vector
        (reference CwiseProduct, `CommonFunctions/CwiseProduct.h`)."""
        if not isinstance(other, VectorFunction):
            arr = np.asarray(other, np.float64).ravel()
            f = self._fn
            return VectorFunction(lambda x: jnp.atleast_1d(f(x)) * arr,
                                  self._ir, self._orr, name="cwiseProduct")
        other = _stack_arg(other, irows=self._ir)
        if other.ORows() != self._orr:
            raise ValueError("cwiseProduct: output sizes differ")
        f, g = self._fn, other._fn
        return VectorFunction(
            lambda x: jnp.atleast_1d(f(x)) * jnp.atleast_1d(g(x)),
            self._ir, self._orr, name="cwiseProduct")

    def cwiseQuotient(self, other):
        """Elementwise quotient (reference CwiseQuotient)."""
        if not isinstance(other, VectorFunction):
            arr = np.asarray(other, np.float64).ravel()
            f = self._fn
            return VectorFunction(lambda x: jnp.atleast_1d(f(x)) / arr,
                                  self._ir, self._orr, name="cwiseQuotient")
        other = _stack_arg(other, irows=self._ir)
        if other.ORows() != self._orr:
            raise ValueError("cwiseQuotient: output sizes differ")
        f, g = self._fn, other._fn
        return VectorFunction(
            lambda x: jnp.atleast_1d(f(x)) / jnp.atleast_1d(g(x)),
            self._ir, self._orr, name="cwiseQuotient")

    def norm(self):
        f = self._fn
        return VectorFunction(
            lambda x: jnp.linalg.norm(jnp.atleast_1d(f(x)), keepdims=True)
            if False else jnp.atleast_1d(jnp.sqrt(jnp.sum(jnp.square(f(x))))),
            self._ir, 1, name="norm")

    def squared(self):
        """Elementwise square (reference `.squared()` on scalar funcs)."""
        f = self._fn
        return VectorFunction(
            lambda x: jnp.square(jnp.atleast_1d(f(x))),
            self._ir, self._orr, name="squared")

    def squared_norm(self):
        f = self._fn
        return VectorFunction(
            lambda x: jnp.atleast_1d(jnp.sum(jnp.square(f(x)))),
            self._ir, 1, name="squared_norm")

    def inverse_norm(self):
        f = self._fn
        return VectorFunction(
            lambda x: jnp.atleast_1d(1.0 / jnp.sqrt(jnp.sum(jnp.square(f(x))))),
            self._ir, 1, name="inverse_norm")

    def normalized(self):
        f = self._fn
        def impl(x):
            v = jnp.atleast_1d(f(x))
            return v / jnp.sqrt(jnp.sum(jnp.square(v)))
        return VectorFunction(impl, self._ir, self._orr, name="normalized")

    def normalized_power2(self):
        """v / |v|^2"""
        f = self._fn
        def impl(x):
            v = jnp.atleast_1d(f(x))
            return v / jnp.sum(jnp.square(v))
        return VectorFunction(impl, self._ir, self._orr, name="normalized_power2")

    def normalized_power3(self, offset=None, scale=None):
        """v / |v|^3 (two-body gravity kernel shape).

        Optional (offset, scale) form (reference NormalizedPower3 overload,
        used by frame EOMs): scale * (v + offset) / |v + offset|^3."""
        f = self._fn
        off = None if offset is None else np.asarray(offset, np.float64)
        sc = 1.0 if scale is None else float(scale)
        def impl(x):
            v = jnp.atleast_1d(f(x))
            if off is not None:
                v = v + off
            n2 = jnp.sum(jnp.square(v))
            return sc * v / (n2 * jnp.sqrt(n2))
        return VectorFunction(impl, self._ir, self._orr, name="normalized_power3")

    def normalized_power4(self):
        f = self._fn
        def impl(x):
            v = jnp.atleast_1d(f(x))
            n2 = jnp.sum(jnp.square(v))
            return v / (n2 * n2)
        return VectorFunction(impl, self._ir, self._orr, name="normalized_power4")

    def normalized_power5(self):
        f = self._fn
        def impl(x):
            v = jnp.atleast_1d(f(x))
            n2 = jnp.sum(jnp.square(v))
            return v / (n2 * n2 * jnp.sqrt(n2))
        return VectorFunction(impl, self._ir, self._orr, name="normalized_power5")

    # --------------------------------------------------------------- padding
    def padded_lower(self, n):
        """Append n zeros below the output."""
        n = int(n)
        f = self._fn
        return VectorFunction(
            lambda x: jnp.concatenate(
                [jnp.atleast_1d(f(x)),
                 jnp.zeros((n,), dtype=DEFAULT_DTYPE)]),
            self._ir, self._orr + n, name="padded_lower")

    def padded_upper(self, n):
        """Prepend n zeros above the output."""
        n = int(n)
        f = self._fn
        return VectorFunction(
            lambda x: jnp.concatenate(
                [jnp.zeros((n,), dtype=DEFAULT_DTYPE),
                 jnp.atleast_1d(f(x))]),
            self._ir, self._orr + n, name="padded_upper")

    # -------------------------------------------------------------- cwise map
    def cwise(self, op, name="cwise"):
        f = self._fn
        return VectorFunction(lambda x: op(jnp.atleast_1d(f(x))),
                              self._ir, self._orr, name=name)

    # ASSET naming compat
    def sf(self):
        if self._orr != 1:
            raise ValueError("sf(): output is not scalar")
        return self

    def vf(self):
        return self

    # --------------------------------------------------------- conditionals
    def _compare(self, other, op, name):
        if self._orr != 1:
            raise ValueError("comparisons require scalar functions")
        if _is_numericlike(other) and not isinstance(other, VectorFunction):
            c = float(np.asarray(other).ravel()[0])
            f = self._fn
            return ConditionalFunction(
                lambda x: op(jnp.atleast_1d(f(x))[0], c), self._ir, name=name)
        other = _stack_arg(other, irows=self._ir)
        if other.ORows() != 1:
            raise ValueError("comparisons require scalar functions")
        f, g = self._fn, other._fn
        return ConditionalFunction(
            lambda x: op(jnp.atleast_1d(f(x))[0], jnp.atleast_1d(g(x))[0]),
            self._ir, name=name)

    def __lt__(self, other):
        return self._compare(other, jnp.less, "lt")

    def __le__(self, other):
        return self._compare(other, jnp.less_equal, "le")

    def __gt__(self, other):
        return self._compare(other, jnp.greater, "gt")

    def __ge__(self, other):
        return self._compare(other, jnp.greater_equal, "ge")


class ScalarFunction(VectorFunction):
    """Subclassable scalar-output function (reference `vf.ScalarFunction`):
    ``class obj(vf.ScalarFunction): def __init__(self): super().__init__(expr)``
    wraps an existing scalar expression."""

    def __init__(self, expr, irows=None, name=None):
        if isinstance(expr, VectorFunction):
            if expr.ORows() != 1:
                raise ValueError("ScalarFunction requires a 1-output function")
            super().__init__(expr._fn, expr.IRows(), 1,
                             name=name or expr.name)
        else:
            if irows is None:
                raise ValueError("ScalarFunction from a raw closure needs irows")
            super().__init__(expr, irows, 1, name=name or "ScalarFunction")


class ConditionalFunction:
    """Boolean-valued predicate over R^IRows, combinable with & and |.

    Reference: `src/VectorFunctions/CommonFunctions/Conditional.h`.
    """

    def __init__(self, fn, irows, name="cond"):
        self._fn = fn
        self._ir = int(irows)
        self._name = name

    def IRows(self):
        return self._ir

    def trace(self, x):
        return self._fn(x)

    def compute(self, x):
        x = jnp.asarray(x, dtype=DEFAULT_DTYPE).ravel()
        return bool(np.asarray(self._fn(x)))

    def __and__(self, other):
        f, g = self._fn, other._fn
        return ConditionalFunction(
            lambda x: jnp.logical_and(f(x), g(x)), self._ir, name="and")

    def __or__(self, other):
        f, g = self._fn, other._fn
        return ConditionalFunction(
            lambda x: jnp.logical_or(f(x), g(x)), self._ir, name="or")

    def __invert__(self):
        f = self._fn
        return ConditionalFunction(
            lambda x: jnp.logical_not(f(x)), self._ir, name="not")


class Arguments(VectorFunction):
    """Identity function on R^n: the root of every expression.

    Reference: `src/VectorFunctions/CommonFunctions/Segment.h` Arguments.
    """

    def __init__(self, n):
        n = int(n)
        super().__init__(lambda x: x, n, n, name=f"Arguments[{n}]")


def Constant(irows, value):
    """Constant output function of given input size."""
    a = _const_array(value)
    return VectorFunction(lambda x: a, int(irows), int(a.shape[0]),
                          name="Constant")


def _stack_arg(v, irows=None):
    """Promote stack()/dot() arguments: functions pass through, lists of
    functions get stacked, numerics become constants."""
    if isinstance(v, VectorFunction):
        return v
    if isinstance(v, (list, tuple)) and any(
            isinstance(e, VectorFunction) for e in v):
        return stack(list(v))
    return as_function(v, irows=irows)


def stack(*funcs):
    """Stack outputs of functions/constants sharing one input space.

    Reference: `src/VectorFunctions/CommonFunctions/StackedOutputs` (vf.stack).
    Accepts stack([f1,f2,...]) or stack(f1, f2, ...); numeric entries become
    constants.
    """
    if len(funcs) == 1 and isinstance(funcs[0], (list, tuple)):
        funcs = tuple(funcs[0])
    ir = None
    for f in funcs:
        if isinstance(f, VectorFunction):
            ir = f.IRows()
            break
    if ir is None:
        raise ValueError("stack needs at least one VectorFunction")
    parts = []
    orows = 0
    for f in funcs:
        if isinstance(f, VectorFunction):
            if f.IRows() != ir:
                raise ValueError("stack: all functions must share input size")
            parts.append(f)
        else:
            parts.append(as_function(f, irows=ir))
        orows += parts[-1].ORows()
    fns = [p._fn for p in parts]
    return VectorFunction(
        lambda x: jnp.concatenate([jnp.atleast_1d(fn(x)) for fn in fns]),
        ir, orows, name="stack")
