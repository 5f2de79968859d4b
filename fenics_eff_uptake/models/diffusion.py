"""Steady pure-diffusion concentration solves with Robin uptake.

JAX equivalent of ``pure_diffusion_solver`` /
``pure_diffusion_solver_variable_mu`` (ref solvers.py:113-231):

  weak form:  D grad(c).grad(phi) dx + mu(x) c phi ds_4
  BCs:        c=1 on left (marker 1), c=0 on right (marker 2) (Dirichlet),
              Robin on the whole bottom (marker 4).

Solves route through the chunked batched engine (parallel/sweep.py, B=1):
one code path for single runs and sweeps, in bounded device dispatches.  Post-solve the reference's tiny-negative
clamp (|min| < 1e-12 -> 0) is applied (ref solvers.py:154-173, 216-228).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.assembly import (advection_block, constrained_operator,
                            constrained_rhs, make_bc, robin_facet_block,
                            stiffness_block)
from ..fem.space import Function, FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..ops.elemspmv import SumOperator
from ..solvers.cg import cg, jacobi_preconditioner

__all__ = ["build_diffusion_system", "pure_diffusion_solve"]


class LinearSystem(NamedTuple):
    op: SumOperator
    bc: "object"
    apply: Callable
    rhs: jnp.ndarray
    precond: Callable
    space: FunctionSpace


def build_diffusion_system(space: FunctionSpace, D, mu,
                           u_values=None, u_space=None) -> LinearSystem:
    """Assemble the (adv-)diffusion + Robin operator with Dirichlet BCs.

    (Retained for unit tests / scipy cross-checks; production solves go
    through parallel/sweep.py.)
    """
    mesh = space.mesh
    blocks = [stiffness_block(space, D=D)]
    if u_values is not None:
        blocks.append(advection_block(space, u_values, u_space))
    bottom = mesh.bc_marker == MARKERS["bottom"]
    if bottom.any():
        blocks.append(robin_facet_block(space, bottom, mu))
    op = SumOperator(blocks, space.ndofs)
    bc = make_bc(space, [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)])
    apply = constrained_operator(op, bc)
    rhs = constrained_rhs(op, bc)
    diag = op.diagonal()
    precond = jacobi_preconditioner(diag, bc.free)
    return LinearSystem(op=op, bc=bc, apply=apply, rhs=rhs,
                        precond=precond, space=space)


def _clamp_tiny_negative(values):
    """Clamp tiny negative entries to 0 (ref solvers.py:154-173)."""
    mn = jnp.min(values)
    return jnp.where((mn < 0) & (jnp.abs(mn) < 1e-12),
                     jnp.maximum(values, 0.0), values)


def _transport_solve(mesh: MeshData, D, mu, element, rtol, maxiter,
                     u: Optional[Function] = None,
                     coarse_mesh=None, solver=None) -> Function:
    """Shared single-run solve via the chunked batched engine (B=1).

    solver="gmres" routes through restarted GMRES (solvers/gmres.py) --
    the robust choice for strongly nonsymmetric high-Pe systems where
    BiCGStab's short recurrence can stagnate (BASELINE config #5).
    "auto" (advdiff default) picks GMRES when Pe = 1/D > 25.
    """
    from ..parallel.sweep import (build_transport_system,
                                  robin_matrices_for_mu, solve_sweep)
    u_values = None if u is None else u.values
    u_space = None if u is None else u.space
    sys_t = build_transport_system(mesh, element=element,
                                   u_values=u_values, u_space=u_space)
    if solver == "auto":
        solver = "gmres" if (u is not None and float(D) > 0
                             and 1.0 / float(D) > 25.0) else None
    if solver == "gmres":
        return _gmres_transport_solve(sys_t, D, mu, rtol, maxiter)
    from ..solvers.multilevel import build_multilevel_for
    if np.isscalar(mu):
        ml = build_multilevel_for(sys_t, mesh, [float(D)],
                                  mu_values=[float(mu)], u_fine=u)
        X, info = solve_sweep(sys_t, [float(D)], mu_values=[float(mu)],
                              rtol=rtol, maxiter=maxiter,
                              multilevel=ml,
                              coarse_mesh=None if ml is not None
                              else coarse_mesh)
    else:
        R = np.asarray(robin_matrices_for_mu(sys_t, mu))[None]
        ml = build_multilevel_for(sys_t, mesh, [float(D)],
                                  mu_callables=[mu],
                                  robin_matrices_fine=R, u_fine=u)
        X, info = solve_sweep(sys_t, [float(D)], robin_matrices=R,
                              rtol=rtol, maxiter=maxiter,
                              multilevel=ml,
                              coarse_mesh=None if ml is not None
                              else coarse_mesh)
    vals = X[0]
    vals = jnp.where(jnp.isfinite(vals), vals, 0.0)
    vals = _clamp_tiny_negative(vals)
    fn = Function(sys_t.space, vals)
    fn.solver_info = {
        "iters": int(info["iters"][0]),
        "resnorm": float(info["resnorm"][0]),
        "converged": bool(np.isfinite(info["resnorm"][0])),
    }
    return fn


def _gmres_transport_solve(sys_t, D, mu, rtol, maxiter) -> Function:
    """Single-system restarted-GMRES path (high-Pe robustness)."""
    import jax
    from ..parallel.sweep import (_operator_program, operator_args,
                                  robin_matrices_for_mu, sys_struct_key)
    from ..solvers.gmres import gmres

    if np.isscalar(mu):
        R_batch = None
        mu_vec = jnp.asarray([float(mu)])
    else:
        R_batch = jnp.asarray(
            np.asarray(robin_matrices_for_mu(sys_t, mu))[None])
        mu_vec = jnp.zeros(1)
    D_vec = jnp.asarray([float(D)])
    A_fn, rhs_fn, _, diag_fn = _operator_program(sys_struct_key(sys_t))
    a = operator_args(sys_t, D_vec, mu_vec, R_batch, f32=False)
    G = sys_t.bc_values[:, None]
    rhs = rhs_fn(a, G)[:, 0]
    dinv = diag_fn(a)[:, 0]
    res = gmres(lambda x: A_fn(a, x[:, None])[:, 0], rhs,
                M=lambda r: dinv * r, rtol=rtol, restart=60,
                maxiter=maxiter)
    from ..parallel.sweep import unpermute_columns
    vals = unpermute_columns(sys_t, res.x[None, :])[0]
    vals = jnp.where(jnp.isfinite(vals), vals, 0.0)
    vals = _clamp_tiny_negative(vals)
    fn = Function(sys_t.space, vals)
    fn.solver_info = {"iters": int(res.iters),
                      "resnorm": float(res.resnorm),
                      "converged": bool(res.converged),
                      "method": "gmres"}
    return fn


def pure_diffusion_solve(mesh: MeshData, D=1.0, mu=1.0, element="P2",
                         rtol=1e-13, maxiter=50000,
                         coarse_mesh=None) -> Function:
    """End-to-end pure-diffusion solve; returns the concentration Function.

    ``mu`` may be a scalar or a vectorised mu(x) callable (variable-mu path,
    ref solvers.py:176-231 -- callables are clamped to >= 0 at quadrature
    points inside robin_facet_block).
    """
    return _transport_solve(mesh, D, mu, element, rtol, maxiter,
                            coarse_mesh=coarse_mesh)
