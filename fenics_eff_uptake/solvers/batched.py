"""Blocked (multi-RHS) Krylov solvers in batch-minor (n, B) layout.

Why this exists: in the EXPLICIT batch-minor (n, B) layout the batch axis
sits in the minor dimension, so every irregular gather/scatter of the
unstructured mesh amortises across the whole sweep -- which is why sweeps
are first-class in this framework (SURVEY.md 2.3).

Dispatch chunking: the iteration loop is split into fixed-size jitted
chunks (lax.fori_loop inside, host loop outside, transferring only (B,)
residual norms between chunks).  Converged columns are frozen via
per-column step masks.

All operators here map (n, B) -> (n, B); per-column coefficient scaling is
the caller's job (parallel/sweep.py).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["batched_cg", "batched_bicgstab", "BatchedResult"]


class BatchedResult(NamedTuple):
    X: jnp.ndarray           # (n, B)
    iters: np.ndarray        # (B,)
    resnorm: np.ndarray      # (B,)
    converged: np.ndarray    # (B,)


def _colnorm(X):
    return jnp.sqrt(jnp.sum(X * X, axis=0))


def _as_op(op):
    """Normalise an operator to (fn(args, X), args).

    Plain callables close over their arrays, which embeds them as HLO
    CONSTANTS -- fine for MB-scale element arrays but not for very large
    ones (e.g. the two-level coarse inverses), which bloat the program
    and recompile per value.  Pass such operators as (fn, args) so the
    arrays enter the jitted chunk as ARGUMENTS.
    """
    if isinstance(op, tuple):
        return op
    if op is None:
        return (lambda args, X: X), ()
    return (lambda args, X, _op=op: _op(X)), ()


_CHUNK_CACHE = {}


def _cached_chunk(builder, A, M, n_iters):
    """Cache jitted chunks by operator/preconditioner identity: repeated
    solves with the same closures (e.g. Stokes inner solves, sweep
    refinement passes) must not re-trace."""
    key = (builder.__name__, id(A), id(M), n_iters)
    hit = _CHUNK_CACHE.get(key)
    if hit is not None and hit[1] is A and hit[2] is M:
        return hit[0]
    fn = builder(A, M, n_iters)
    _CHUNK_CACHE[key] = (fn, A, M)
    return fn


def _cg_chunk(A_fn, M_fn, n_iters):
    """Jitted CG chunk: advances all columns n_iters steps (frozen when
    converged).  Operator/preconditioner arrays arrive as arguments."""

    @jax.jit
    def chunk(a_args, m_args, X, R, Z, P, rz, tol):
        def body(_, state):
            X, R, Z, P, rz, cnt = state
            active = _colnorm(R) > tol                     # (B,)
            AP = A_fn(a_args, P)
            pAp = jnp.sum(P * AP, axis=0)
            alpha = jnp.where(active & (pAp != 0),
                              rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
            X = X + alpha[None, :] * P
            R = R - alpha[None, :] * AP
            Z = M_fn(m_args, R)
            rz_new = jnp.sum(R * Z, axis=0)
            beta = jnp.where(active & (rz != 0),
                             rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
            P = jnp.where(active[None, :], Z + beta[None, :] * P, P)
            return (X, R, Z, P, rz_new, cnt + active.astype(jnp.int32))

        cnt = jnp.zeros(R.shape[1], jnp.int32)
        X, R, Z, P, rz, cnt = jax.lax.fori_loop(
            0, n_iters, body, (X, R, Z, P, rz, cnt))
        return X, R, Z, P, rz, _colnorm(R), cnt

    return chunk


def _chunk_schedule(chunk_iters):
    """Escalating dispatch sizes up to chunk_iters: 50, 100, 200, ...

    A chunk executes ALL its iterations (converged columns are masked,
    not skipped), so opening a well-preconditioned solve (~25-40 MG-CG
    iterations) with one worst-case 400/800-iteration chunk burns up to
    ~25x the useful FLOPs -- the dominant cost of f64/CPU solves.  The
    doubling ladder bounds overshoot at <2x optimal while hard solves
    still escalate to full-size dispatches; sizes stay in the fixed
    quantized set {50, 100, 200, 400, 800, chunk_iters} so compiled
    chunk kernels are shared across meshes/batches.  An explicit
    chunk_iters <= 50 keeps today's fixed-size behaviour.
    """
    out, n = [], 50
    while n < chunk_iters:
        out.append(n)
        n *= 2
    out.append(int(chunk_iters))
    return out


# opening residual (and preconditioned residual) as compiled programs:
# A_fn/M_fn are static (cached program functions); eager, every
# primitive of the operator and the V-cycle would compile alone
@partial(jax.jit, static_argnums=(0,))
def _residual(A_fn, a_args, B_rhs, X0):
    return B_rhs - A_fn(a_args, X0)


@partial(jax.jit, static_argnums=(0, 1))
def _cg_start(A_fn, M_fn, a_args, m_args, B_rhs, X0):
    R = B_rhs - A_fn(a_args, X0)
    return R, M_fn(m_args, R)


def batched_cg(A, B_rhs, M=None,
               X0=None, rtol=1e-12, atol=0.0, maxiter=20000,
               chunk_iters=400) -> BatchedResult:
    """Preconditioned CG on (n, B) right-hand sides.

    A and M are callables X->Y, or (fn(args, X), args) pairs (preferred
    when the operator holds very large arrays -- see _as_op).
    """
    A_fn, a_args = _as_op(A)
    M_fn, m_args = _as_op(M)
    if X0 is None:
        X0 = jnp.zeros_like(B_rhs)
    bnorm = _colnorm(B_rhs)
    tol = jnp.maximum(rtol * bnorm, atol)

    R, Z = _cg_start(A_fn, M_fn, a_args, m_args, B_rhs, X0)
    P = Z
    rz = jnp.sum(R * Z, axis=0)
    X = X0
    schedule = _chunk_schedule(chunk_iters)

    B = B_rhs.shape[1]
    iters = 0
    n_disp = 0
    rn = np.asarray(_colnorm(R))
    tol_np = np.asarray(tol)
    # per-column iteration counts: steps each column took while above
    # its tolerance (a chunk runs all its steps, converged columns masked)
    col_iters = np.zeros(B, dtype=np.int64)
    while iters < maxiter and (rn > tol_np).any():
        size = schedule[min(n_disp, len(schedule) - 1)]
        chunk = _cached_chunk(_cg_chunk, A_fn, M_fn, size)
        X, R, Z, P, rz, rn_dev, cnt = chunk(a_args, m_args, X, R, Z, P,
                                            rz, tol)
        iters += size
        n_disp += 1
        rn = np.asarray(rn_dev)
        col_iters += np.asarray(cnt)
    return BatchedResult(X=X, iters=col_iters,
                         resnorm=rn, converged=rn <= tol_np)


def _bicgstab_chunk(A_fn, M_fn, n_iters):
    @jax.jit
    def chunk(a_args, m_args, X, R, Rhat, P, V, rho, alpha, omega, tol):
        def body(_, state):
            X, R, P, V, rho, alpha, omega, cnt = state
            active = _colnorm(R) > tol
            rho_new = jnp.sum(Rhat * R, axis=0)
            beta = jnp.where(
                active,
                (rho_new / jnp.where(rho != 0, rho, 1.0))
                * (alpha / jnp.where(omega != 0, omega, 1.0)), 0.0)
            P = jnp.where(active[None, :],
                          R + beta[None, :] * (P - omega[None, :] * V), P)
            Phat = M_fn(m_args, P)
            V = A_fn(a_args, Phat)
            denom = jnp.sum(Rhat * V, axis=0)
            alpha = jnp.where(active & (denom != 0),
                              rho_new / jnp.where(denom != 0, denom, 1.0),
                              0.0)
            S = R - alpha[None, :] * V
            Shat = M_fn(m_args, S)
            T = A_fn(a_args, Shat)
            tt = jnp.sum(T * T, axis=0)
            omega = jnp.where(active & (tt != 0),
                              jnp.sum(T * S, axis=0)
                              / jnp.where(tt != 0, tt, 1.0), 0.0)
            X = X + alpha[None, :] * Phat + omega[None, :] * Shat
            R = jnp.where(active[None, :], S - omega[None, :] * T, R)
            return (X, R, P, V, rho_new, alpha, omega,
                    cnt + active.astype(jnp.int32))

        cnt = jnp.zeros(R.shape[1], jnp.int32)
        X, R, P, V, rho, alpha, omega, cnt = jax.lax.fori_loop(
            0, n_iters, body, (X, R, P, V, rho, alpha, omega, cnt))
        return X, R, P, V, rho, alpha, omega, _colnorm(R), cnt

    return chunk


def batched_bicgstab(A, B_rhs, M=None,
                     X0=None, rtol=1e-12, atol=0.0, maxiter=20000,
                     chunk_iters=200) -> BatchedResult:
    """Preconditioned BiCGStab on (n, B) right-hand sides.

    A and M as in batched_cg: callables or (fn(args, X), args) pairs.
    """
    A_fn, a_args = _as_op(A)
    M_fn, m_args = _as_op(M)
    if X0 is None:
        X0 = jnp.zeros_like(B_rhs)
    bnorm = _colnorm(B_rhs)
    tol = jnp.maximum(rtol * bnorm, atol)

    R = _residual(A_fn, a_args, B_rhs, X0)
    Rhat = R
    B = B_rhs.shape[1]
    ones = jnp.ones(B, dtype=B_rhs.dtype)
    zerosV = jnp.zeros_like(B_rhs)
    X, P, V = X0, zerosV, zerosV
    rho = alpha = omega = ones
    schedule = _chunk_schedule(chunk_iters)

    iters = 0
    n_disp = 0
    rn = np.asarray(_colnorm(R))
    tol_np = np.asarray(tol)
    col_iters = np.zeros(B, dtype=np.int64)
    while iters < maxiter and (rn > tol_np).any():
        size = schedule[min(n_disp, len(schedule) - 1)]
        chunk = _cached_chunk(_bicgstab_chunk, A_fn, M_fn, size)
        X, R, P, V, rho, alpha, omega, rn_dev, cnt = chunk(
            a_args, m_args, X, R, Rhat, P, V, rho, alpha, omega, tol)
        iters += size
        n_disp += 1
        rn = np.asarray(rn_dev)
        col_iters += np.asarray(cnt)
    return BatchedResult(X=X, iters=col_iters,
                         resnorm=rn, converged=rn <= tol_np)
