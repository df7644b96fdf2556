"""Embedded scalar root solve as a differentiable expression node.

Reference: `src/VectorFunctions/CommonFunctions/RootFinder.h:29-50`
(ScalarRootFinder): given a scalar function FX whose FIRST input is the
iteration variable (its incoming value is the initial guess) and whose
remaining inputs are parameters, the node outputs the root x* with
FX(x*, params) = 0, differentiated w.r.t. the parameters by the implicit
function theorem.  JAX design: `lax.custom_root` supplies the implicit
derivative; the solve itself is a damped Newton `lax.while_loop`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .function import VectorFunction

__all__ = ["ScalarRootFinder", "RootFinder"]


def ScalarRootFinder(fx, tol=1.0e-12, MaxIters=25):
    """VectorFunction (n -> 1): root of fx's first input.

    fx: VectorFunction with IRows() = n, ORows() = 1; input layout
    [x_guess, params...].  Output: x* with fx(x*, params) = 0.
    """
    if fx.ORows() != 1:
        raise ValueError("ScalarRootFinder requires a scalar function")
    n = fx.IRows()
    trace = fx.trace
    tol = float(tol)
    MaxIters = int(MaxIters)

    def impl(inp):
        x0 = inp[0]
        params = inp[1:]

        def f(z):
            return jnp.atleast_1d(
                trace(jnp.concatenate([z[None], params])))[0]

        def solve(g, x):
            gp = jax.grad(g)

            def body(c):
                x, _, it = c
                fv = g(x)
                dv = gp(x)
                step = fv / jnp.where(jnp.abs(dv) > 1e-300, dv, 1.0)
                return x - step, jnp.abs(step), it + 1

            def cond(c):
                _, err, it = c
                return (err > tol) & (it < MaxIters)

            x, _, _ = jax.lax.while_loop(
                cond, body, (x, jnp.asarray(jnp.inf, inp.dtype),
                             jnp.zeros((), jnp.int32)))
            return x

        def tangent_solve(g, y):
            # g is linear in the tangent: x = y / g'(1)
            return y / g(jnp.ones_like(y))

        root = jax.lax.custom_root(f, x0, solve, tangent_solve)
        return root[None]

    return VectorFunction(impl, n, 1, name="ScalarRootFinder")


# reference exposes the same node under both names
RootFinder = ScalarRootFinder
