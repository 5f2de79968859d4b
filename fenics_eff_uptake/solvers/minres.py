"""Chunked preconditioned MINRES over pytree vectors.

For the Stokes saddle system [[A, B^T], [B, 0]] with the block-diagonal
SPD preconditioner diag(MG(A), lumped pressure mass) -- the classical
Silvester--Wathen approach: iteration counts are mesh-independent, and
each iteration costs one saddle apply + one V-cycle, replacing round-1's
Uzawa/Schur-CG whose nested inner solves ran 10-40k Jacobi-CG iterations
per Stokes field (ROADMAP item 4; ref solvers.py:291-298 is a direct LU).

Vectors are arbitrary pytrees (here: (U (ns,2) scalar-layout velocity,
p (np,)) tuples), so the velocity block reuses the batch-minor scalar
element kernels with B=2 -- the vector Laplacian is kron(K_scalar, I_2).

Same dispatch-chunking protocol as solvers/batched.py: fixed-iteration
jitted chunks on device, only scalars crossing the host boundary.
"""

from __future__ import annotations

import operator
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["minres_tree", "minres_body", "MinresResult"]


class MinresResult(NamedTuple):
    x: "object"
    iters: int
    resnorm: float          # preconditioned residual norm estimate
    true_resnorm: float     # ||b - A x|| (computed at exit)
    converged: bool


def _dot(a, b):
    parts = jax.tree.map(
        lambda x, y: jnp.sum(x.astype(jnp.float64)
                             * y.astype(jnp.float64)), a, b)
    return jax.tree.reduce(operator.add, parts)


def _axpy(alpha, x, y):
    """alpha * x + y (alpha cast to each leaf dtype: f32 vectors must not
    silently promote to f64)"""
    return jax.tree.map(
        lambda xi, yi: jnp.asarray(alpha).astype(xi.dtype) * xi + yi, x, y)


def _scale(alpha, x):
    return jax.tree.map(
        lambda xi: jnp.asarray(alpha).astype(xi.dtype) * xi, x)


def _norm(a):
    return jnp.sqrt(_dot(a, a))


def _as_op(op_):
    if isinstance(op_, tuple):
        return op_
    return (lambda args, X, _op=op_: _op(X)), ()


_CHUNK_CACHE = {}


def minres_body(A_fn, M_fn):
    """One ESW Algorithm 6.1 (preconditioned MINRES) step as a
    fori_loop body over the 14-tuple state.  Shared by the single-chip
    chunk below and the shard_map'ed chunk in parallel/sharded_solve.py
    (where A_fn/M_fn are per-shard applies with psum("cells") inside)."""

    def make(a_args, m_args, tol):
        def body(_, st):
            (x, v_old, v, z, gam_old, gam, eta,
             s_old, s, c_old, c, w_old, w, it) = st
            active = jnp.abs(eta) > tol
            ginv = jnp.where(gam != 0, 1.0 / jnp.where(gam != 0, gam, 1.0),
                             0.0)
            zh = _scale(ginv, z)
            Az = A_fn(a_args, zh)
            delta = _dot(Az, zh)
            v_new = _axpy(-delta * ginv, v, Az)
            g_ratio = jnp.where(gam_old != 0,
                                gam / jnp.where(gam_old != 0, gam_old,
                                                1.0), 0.0)
            v_new = _axpy(-g_ratio, v_old, v_new)
            z_new = M_fn(m_args, v_new)
            gg = _dot(z_new, v_new)
            gam_new = jnp.sqrt(jnp.maximum(gg, 0.0))
            a0 = c * delta - c_old * s * gam
            a1 = jnp.sqrt(a0 * a0 + gam_new * gam_new)
            a2 = s * delta + c_old * c * gam
            a3 = s_old * gam
            a1inv = jnp.where(a1 != 0,
                              1.0 / jnp.where(a1 != 0, a1, 1.0), 0.0)
            c_new = a0 * a1inv
            s_new = gam_new * a1inv
            w_new = _axpy(-a3, w_old, zh)
            w_new = _axpy(-a2, w, w_new)
            w_new = _scale(a1inv, w_new)
            x_new = _axpy(c_new * eta, w_new, x)
            eta_new = -s_new * eta

            def sel(new, old):
                return jax.tree.map(
                    lambda n_, o_: jnp.where(active, n_, o_), new, old)

            return (sel(x_new, x), sel(v, v_old), sel(v_new, v),
                    sel(z_new, z),
                    jnp.where(active, gam, gam_old),
                    jnp.where(active, gam_new, gam),
                    jnp.where(active, eta_new, eta),
                    jnp.where(active, s, s_old),
                    jnp.where(active, s_new, s),
                    jnp.where(active, c, c_old),
                    jnp.where(active, c_new, c),
                    sel(w, w_old), sel(w_new, w),
                    jnp.where(active, it + 1, it))  # true iteration count

        return body

    return make


def _minres_chunk(A_fn, M_fn, n_iters):
    """Jitted n_iters-step MINRES chunk (single-chip path)."""
    body_maker = minres_body(A_fn, M_fn)

    @jax.jit
    def chunk(a_args, m_args, state, tol):
        body = body_maker(a_args, m_args, tol)
        st = jax.lax.fori_loop(0, n_iters, body, state)
        return st, jnp.abs(st[6])

    return chunk


# the opening residual/preconditioner and the closing true residual run
# as compiled programs (A_fn/M_fn are static: cached program functions);
# eager, every primitive of the saddle apply and V-cycle compiles alone
@partial(jax.jit, static_argnums=(0, 1))
def _minres_start(A_fn, M_fn, a_args, m_args, b, x0):
    v = _axpy(-1.0, A_fn(a_args, x0), b)        # b - A x0
    z = M_fn(m_args, v)
    return v, z, jnp.sqrt(jnp.maximum(_dot(z, v), 0.0))


@partial(jax.jit, static_argnums=(0,))
def _true_resnorm(A_fn, a_args, x, b):
    return _norm(_axpy(-1.0, A_fn(a_args, x), b))


def minres_tree(A, b, M=None, x0=None, rtol=1e-10, maxiter=2000,
                chunk_iters=50) -> MinresResult:
    """Preconditioned MINRES; A symmetric, M SPD; vectors are pytrees.

    A and M are callables or (fn(args, X), args) pairs.
    """
    A_fn, a_args = _as_op(A)
    if M is None:
        M = lambda X: X
    M_fn, m_args = _as_op(M)
    if x0 is None:
        x0 = jax.tree.map(jnp.zeros_like, b)

    v, z, gam = _minres_start(A_fn, M_fn, a_args, m_args, b, x0)
    zero = jnp.asarray(0.0, dtype=jnp.float64)
    one = jnp.asarray(1.0, dtype=jnp.float64)
    zeros_vec = jax.tree.map(jnp.zeros_like, b)
    state = (x0, zeros_vec, v, z, one, gam, gam,
             zero, zero, one, one, zeros_vec, zeros_vec, zero)

    bnorm_prec = float(gam)
    tol = jnp.asarray(rtol * max(bnorm_prec, 1e-300), dtype=jnp.float64)

    key = (id(A_fn), id(M_fn), chunk_iters)
    hit = _CHUNK_CACHE.get(key)
    if hit is not None and hit[1] is A_fn and hit[2] is M_fn:
        chunk = hit[0]
    else:
        chunk = _minres_chunk(A_fn, M_fn, chunk_iters)
        _CHUNK_CACHE[key] = (chunk, A_fn, M_fn)

    import os as _os
    import time as _time
    _dbg = _os.environ.get("FEU_TIMING") == "1"
    _tp = _time.perf_counter()

    def _tick(msg):
        nonlocal _tp
        if _dbg:
            now = _time.perf_counter()
            print(f"    [minres] {msg}: {now - _tp:.2f}s", flush=True)
            _tp = now

    _tick(f"pre-chunk (cache {'hit' if hit is not None else 'miss'})")
    dispatched = 0
    rn = float(gam)
    tol_f = float(tol)
    while dispatched < maxiter and rn > tol_f:
        state, rn_dev = chunk(a_args, m_args, state, tol)
        dispatched += chunk_iters
        rn = float(rn_dev)
        _tick(f"chunk@{dispatched}")
    x = state[0]
    # state[-1] counts only ACTIVE iterations (updates are masked once
    # |eta| <= tol), so this is the true count, not the chunk-quantised
    # dispatch total
    iters = int(state[-1])
    true_rn = float(_true_resnorm(A_fn, a_args, x, b))
    return MinresResult(x=x, iters=iters, resnorm=rn,
                        true_resnorm=true_rn, converged=rn <= tol_f)
