"""Advection-diffusion concentration solves with Robin uptake.

JAX equivalent of ``advdiff_solver`` / ``advdiff_solver_variable_mu``
(ref solvers.py:16-107):

  weak form: D grad(c).grad(phi) dx + (u.grad c) phi dx + mu(x) c phi ds_4
  BCs:       c=1 left (marker 1), c=0 right (marker 2); plain Galerkin, no
             stabilisation (fine at Pe<=10 with CG2; cell Peclet << 1).

Nonsymmetric -> chunked batched BiCGStab (parallel/sweep.py, B=1).
Post-solve: clamp non-finite to 0 and tiny negatives (|min| < 1e-12) to 0
(ref solvers.py:86-103).
"""

from __future__ import annotations

from ..fem.space import Function
from ..meshing.mesh_data import MeshData
from .diffusion import _transport_solve

__all__ = ["advdiff_solve"]


def advdiff_solve(mesh: MeshData, u: Function, D, mu, element="P2",
                  rtol=1e-13, maxiter=50000, coarse_mesh=None,
                  solver="auto") -> Function:
    """Solve steady advection-diffusion; ``u`` is the velocity Function.

    solver: None (BiCGStab), "gmres", or "auto" (GMRES when Pe > 25 --
    restarted GMRES is the robust high-Pe choice, BASELINE config #5)."""
    return _transport_solve(mesh, D, mu, element, rtol, maxiter, u=u,
                            coarse_mesh=coarse_mesh, solver=solver)
