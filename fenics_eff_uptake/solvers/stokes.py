"""Stokes saddle-point solver: pressure-Schur (Uzawa) CG, matrix-free.

Replaces the sparse direct LU behind the reference's mixed Taylor-Hood solve
(ref solvers.py:291-298).  The saddle system

    [A  B^T] [u]   [f]
    [B   0 ] [p] = [0],   A = vector Laplacian (with velocity Dirichlet BCs),
                          B = -div coupling

is reduced to the SPD pressure Schur complement S = B A^{-1} B^T:

    S p = B u0,   u0 = A^{-1} f   (BCs folded into A-solves)

Outer CG on S runs on the HOST (tens of iterations, one inner solve each);
inner A-solves use the chunked batched CG engine (solvers/batched.py),
optionally in mixed f32/f64 precision.  The outer preconditioner is the
lumped pressure mass matrix (spectrally equivalent to S for Stokes).

Pressure level: with the do-nothing outlet (right boundary traction-free)
the pressure is determined by the weak form itself; the reference's
"pointwise" outlet pin (solvers.py:272-283) matches no dof under legacy
dolfin pointwise semantics (inside() is called with on_boundary=False), so
no explicit pin is applied here either.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .batched import batched_cg

__all__ = ["stokes_schur_cg", "StokesResult"]


class StokesResult(NamedTuple):
    u: jnp.ndarray
    p: jnp.ndarray
    outer_iters: int
    inner_iters: int
    resnorm: float
    converged: bool


def _col(x):
    return x[:, None]


def stokes_schur_cg(A_apply: Callable, B, bc, f=None,
                    Mp_inv: Callable = None, A_diag=None,
                    A_apply32: Optional[Callable] = None,
                    inner_rtol=1e-12, inner_maxiter=6000,
                    outer_rtol=1e-11, outer_maxiter=300,
                    precision="f64", chunk_iters=150):
    """Solve the constrained Stokes saddle system (host-orchestrated).

    A_apply: unconstrained velocity-block operator on (n,1) columns
    A_apply32: same in f32 (enables mixed-precision inner solves)
    B: RectBlock (pressure rows x velocity cols)
    bc: BCData on the velocity space; Mp_inv: pressure preconditioner.
    """
    free = bc.free
    g = bc.values
    nu = g.shape[0]
    if f is None:
        f = jnp.zeros(nu, dtype=g.dtype)
    if Mp_inv is None:
        Mp_inv = lambda r: r

    dinv = None
    if A_diag is not None:
        d = jnp.where(free & (A_diag != 0), A_diag, 1.0)
        dinv = jnp.where(free, 1.0 / d, 1.0)[:, None]

    freeC = free[:, None]

    def A_bc(X):
        Y = A_apply(jnp.where(freeC, X, 0.0))
        return jnp.where(freeC, Y, X)

    mixed = precision == "mixed" and A_apply32 is not None
    if mixed:
        dinv32 = dinv.astype(jnp.float32) if dinv is not None else None
        M32 = ((lambda r: dinv32 * r) if dinv32 is not None else None)

        def A_bc32(X):
            Y = A_apply32(jnp.where(freeC, X, 0.0))
            return jnp.where(freeC, Y, X)

    inner_count = 0

    def solve_A(rhs_col, x0_col):
        """A^{-1} rhs on free dofs (rhs/x0 are (n,1) with bc entries)."""
        nonlocal inner_count
        if not mixed:
            res = batched_cg(A_bc, rhs_col, X0=x0_col,
                             M=(lambda R: dinv * R) if dinv is not None
                             else None,
                             rtol=inner_rtol, maxiter=inner_maxiter,
                             chunk_iters=chunk_iters)
            inner_count += int(res.iters.max())
            return res.X
        # mixed: f32 inner + f64 refinement.  The inner accuracy floor is
        # relaxed (1e-9): the outer Schur CG tolerates it and each extra
        # decade costs a full refinement sweep.
        X = x0_col
        bnorm = float(jnp.linalg.norm(rhs_col))
        target = max(inner_rtol, 1e-9)
        for _ in range(6):
            R = rhs_col - A_bc(X)
            rn = float(jnp.linalg.norm(R))
            if rn <= target * max(bnorm, 1e-300):
                break
            res = batched_cg(A_bc32, R.astype(jnp.float32),
                             M=M32,
                             rtol=1e-4, maxiter=inner_maxiter,
                             chunk_iters=chunk_iters)
            inner_count += int(res.iters.max())
            X = X + res.X.astype(X.dtype)
        return X

    # jit the small per-outer-iteration pieces: one dispatch each instead
    # of an eager chain
    jBt_rhs = jax.jit(lambda d: jnp.where(free, B.apply_t(d), 0.0)[:, None])
    jB = jax.jit(lambda w: B.apply(w[:, 0]))
    jMp = jax.jit(Mp_inv)

    @jax.jit
    def j_update(p, r, d, Sd, rz):
        dSd = jnp.vdot(d, Sd)
        alpha = jnp.where(dSd != 0, rz / jnp.where(dSd != 0, dSd, 1.0),
                          0.0)
        p2 = p + alpha * d
        r2 = r - alpha * Sd
        z2 = Mp_inv(r2)
        rz_new = jnp.vdot(r2, z2)
        beta = jnp.maximum(jnp.vdot(r2 - r, z2)
                           / jnp.where(rz != 0, rz, 1.0), 0.0)
        d2 = z2 + beta * d
        return p2, r2, z2, d2, rz_new, jnp.linalg.norm(r2), dSd

    # u0 = A^{-1} f with bc values g
    rhs0 = jnp.where(free, f - A_apply(_col(g))[:, 0], g)[:, None]
    u0 = solve_A(rhs0, _col(g))

    b_p = jB(u0)
    bnorm = float(jnp.linalg.norm(b_p))
    tol = outer_rtol * bnorm

    # host-side outer FLEXIBLE CG on the Schur complement: the S
    # applications are inexact (inner Krylov), so use the Polak-Ribiere
    # beta and guard against breakdown (restart on non-positive curvature).
    p = jnp.zeros_like(b_p)
    r = b_p
    z = jMp(r)
    d = z
    rz = float(jnp.vdot(r, z))
    w_prev = jnp.zeros_like(u0)
    k = 0
    rn = float(jnp.linalg.norm(r))
    while rn > tol and k < outer_maxiter:
        w = solve_A(jBt_rhs(d), w_prev)
        w_prev = w
        Sd = jB(w)
        p2, r2, z2, d2, rz_new, rn_dev, dSd_dev = j_update(
            p, r, d, Sd, jnp.asarray(rz, dtype=r.dtype))
        dSd = float(dSd_dev)
        if not np.isfinite(dSd) or dSd <= 0.0:
            # lost conjugacy to inexactness: restart with steepest descent
            d = z
            w = solve_A(jBt_rhs(d), w_prev)
            w_prev = w
            Sd = jB(w)
            p2, r2, z2, d2, rz_new, rn_dev, dSd_dev = j_update(
                p, r, d, Sd, jnp.asarray(rz, dtype=r.dtype))
            if not np.isfinite(float(dSd_dev)) or float(dSd_dev) <= 0.0:
                break
        p, r, z, d = p2, r2, z2, d2
        rz = float(rz_new)
        rn = float(rn_dev)
        k += 1

    # final velocity: u = A^{-1}(f - B^T p) with bc values
    rhs_u = jnp.where(free, f - A_apply(_col(g))[:, 0] - B.apply_t(p),
                      g)[:, None]
    u = solve_A(rhs_u, u0)
    return StokesResult(u=u[:, 0], p=p, outer_iters=k,
                        inner_iters=inner_count,
                        resnorm=rn, converged=rn <= tol)
