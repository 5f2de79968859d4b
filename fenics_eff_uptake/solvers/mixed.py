"""Mixed-precision Krylov: f32 inner solves + f64 iterative refinement.

f32 moves half the bytes of f64 through the memory-bound SpMV, so the bulk
of the work can run in f32 and still reach direct-solver-grade accuracy
through the classic mixed-precision refinement scheme:

    repeat:  r = b - A x          (few f64 SpMVs)
             d = solve(A, r)      (f32 Jacobi-CG / BiCGStab, bulk of work)
             x = x + d            (f64 accumulate)

Each refinement multiplies the error by ~(inner_rtol + kappa * eps_f32);
with inner_rtol 1e-4 and the study's condition numbers this converges to
~1e-13 relative residual in <= 8 sweeps.  Fully jittable (nested
lax.while_loop), vmappable over sweep batches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .bicgstab import bicgstab
from .cg import cg

__all__ = ["refined_solve", "RefinedResult"]


class RefinedResult(NamedTuple):
    x: jnp.ndarray
    refinements: jnp.ndarray
    inner_iters: jnp.ndarray
    resnorm: jnp.ndarray
    converged: jnp.ndarray


def refined_solve(A64: Callable, A32: Callable, b64, M32: Callable = None,
                  rtol=1e-12, inner_rtol=1e-4, inner_maxiter=20000,
                  max_refinements=12, nonsymmetric=False) -> RefinedResult:
    """Solve A x = b to f64 accuracy with f32 inner Krylov solves.

    A64: f64 operator apply; A32: the same operator in f32; M32: f32
    preconditioner.  b64 is f64.
    """
    inner = bicgstab if nonsymmetric else cg
    bnorm = jnp.linalg.norm(b64)
    tol = rtol * bnorm

    def cond(state):
        x, k, it_total, rn = state
        return (rn > tol) & (k < max_refinements)

    def body(state):
        x, k, it_total, rn = state
        r = b64 - A64(x)
        r32 = r.astype(jnp.float32)
        res = inner(A32, r32, M=M32, rtol=inner_rtol,
                    maxiter=inner_maxiter)
        x = x + res.x.astype(b64.dtype)
        rn_new = jnp.linalg.norm(b64 - A64(x))
        return (x, k + 1, it_total + res.iters, rn_new)

    x0 = jnp.zeros_like(b64)
    r0n = bnorm
    x, k, it_total, rn = jax.lax.while_loop(
        cond, body, (x0, jnp.array(0), jnp.array(0), r0n))
    return RefinedResult(x=x, refinements=k, inner_iters=it_total,
                         resnorm=rn, converged=rn <= tol)
