"""Restarted GMRES for nonsymmetric systems (BASELINE.json north star names
GMRES/MINRES for the adv-diff and Stokes paths; BiCGStab is the batched
default, GMRES(m) is the robust fallback for harder nonsymmetric cases,
e.g. higher-Pe runs of the convergence ladder).

Host-orchestrated Arnoldi: each step is ONE jitted matvec dispatch plus
small host linear algebra (the Hessenberg least-squares).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["gmres", "GMRESResult"]


class GMRESResult(NamedTuple):
    x: jnp.ndarray
    iters: int
    resnorm: float
    converged: bool


def gmres(A: Callable, b, x0=None, M: Optional[Callable] = None,
          rtol=1e-12, atol=0.0, restart=50, maxiter=2000) -> GMRESResult:
    """Left-preconditioned restarted GMRES(m)."""
    if M is None:
        M = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    A_j = jax.jit(A)
    M_j = jax.jit(M)

    bnorm = float(jnp.linalg.norm(M_j(b)))
    tol = max(rtol * bnorm, atol)
    x = x0
    total = 0
    rn = np.inf

    while total < maxiter:
        r = M_j(b - A_j(x))
        rn = float(jnp.linalg.norm(r))
        if rn <= tol:
            return GMRESResult(x=x, iters=total, resnorm=rn,
                               converged=True)
        m = min(restart, maxiter - total)
        V = [r / rn]
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = rn
        cs = np.zeros(m)
        sn = np.zeros(m)
        k_used = 0
        for k in range(m):
            w = M_j(A_j(V[k]))
            # modified Gram-Schmidt (host scalars, device vectors)
            for i in range(k + 1):
                hik = float(jnp.vdot(V[i], w))
                H[i, k] = hik
                w = w - hik * V[i]
            hkk = float(jnp.linalg.norm(w))
            H[k + 1, k] = hkk
            # apply previous Givens rotations
            for i in range(k):
                t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -sn[i] * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = t
            denom = np.hypot(H[k, k], H[k + 1, k])
            if denom == 0:
                k_used = k
                break
            cs[k] = H[k, k] / denom
            sn[k] = H[k + 1, k] / denom
            H[k, k] = denom
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k_used = k + 1
            total += 1
            if hkk == 0.0 or abs(g[k + 1]) <= tol:
                break
            V.append(w / hkk)
        # solve the triangular system and update x
        kk = k_used
        if kk > 0:
            y = np.linalg.solve(H[:kk, :kk], g[:kk])
            dx = sum(float(y[i]) * V[i] for i in range(kk))
            x = x + dx
        rn = abs(float(g[kk])) if kk < len(g) else rn
        if rn <= tol:
            break
    r = M_j(b - A_j(x))
    rn = float(jnp.linalg.norm(r))
    return GMRESResult(x=x, iters=total, resnorm=rn, converged=rn <= tol)
