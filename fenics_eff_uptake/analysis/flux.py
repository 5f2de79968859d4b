"""Boundary / interface flux metrics.

JAX re-implementation of the reference flux bookkeeping
(analysis.py:29-333, 640-675): physical flux J = -D grad(c).n + (u.n) c per
boundary, Robin uptake flux mu*c, sulcus segment fluxes, the interior mouth
flux via the channel-side trace (the reference's DG0 rectangle-side selector,
analysis.py:216-241, becomes simply "evaluate on the '+' (channel) cell" in
our two-sided interior facet structure), exchange-strength metrics, and the
y0_flux / y0_combined identity check (analysis.py:294-296).

Output dict structure matches the reference's JSON schema key-for-key.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import jax.numpy as jnp
import numpy as np

from ..fem.space import Function, FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from .facets import FacetQuad, build_facet_quad

__all__ = [
    "physical_flux_facets", "compute_physical_flux_boundary",
    "compute_sulcus_segment_fluxes", "compute_uptake_flux_bottom",
    "compute_uptake_flux_segments", "compute_flux_metrics",
    "boundary_quad", "mouth_quad",
]


def boundary_quad(space: FunctionSpace, facet_mask, degree=4) -> Optional[FacetQuad]:
    mesh = space.mesh
    sel = np.flatnonzero(facet_mask)
    if len(sel) == 0:
        return None
    fs = mesh.boundary
    return build_facet_quad(space, fs.cell[sel], fs.local_edge[sel],
                            degree=degree)


def mouth_quad(space: FunctionSpace, degree=4, side="plus") -> Optional[FacetQuad]:
    """Quadrature on the interior y=0 mouth facets, channel ('+') side.

    The '+'-side normal is the outward normal of the channel cell, i.e. it
    points INTO the cavity -- exactly the reference's rectangle-side trace
    normal chi_rect('+')n('+')+chi_rect('-')n('-') (analysis.py:232-236).
    """
    mesh = space.mesh
    iy = mesh.interior_y0
    if iy is None or len(iy) == 0:
        return None
    if side == "plus":
        return build_facet_quad(space, iy.cell_plus, iy.local_edge_plus,
                                degree=degree)
    return build_facet_quad(space, iy.cell_minus, iy.local_edge_minus,
                            degree=degree)


def physical_flux_facets(fq: FacetQuad, c: Function, u: Optional[Function],
                         D):
    """(diffusive, advective) flux integrals over the facet set.

    diffusive = int -D grad(c).n ds ; advective = int (u.n) c ds
    (ref analysis.py:29-37).
    """
    gq = fq.eval_grad(c.values)                       # (F,Q,2)
    diff_density = -D * jnp.einsum("fqa,fa->fq", gq, fq.normal)
    diffusive = fq.integrate(diff_density)
    if u is None:
        advective = jnp.zeros(())
    else:
        uq = fq.eval_vector(u.values, u.space)        # (F,Q,2)
        un = jnp.einsum("fqa,fa->fq", uq, fq.normal)
        cq = fq.eval(c.values)
        advective = fq.integrate(un * cq)
    return float(diffusive), float(advective)


def compute_physical_flux_boundary(c, u, mesh: MeshData, marker_id, D,
                                   degree=4):
    """Physical flux across one bc-marked boundary (ref analysis.py:55-68)."""
    fq = boundary_quad(c.space, mesh.bc_marker == marker_id, degree)
    if fq is None:
        return {"diffusive": 0.0, "advective": 0.0, "total": 0.0}
    d, a = physical_flux_facets(fq, c, u, D)
    return {"diffusive": d, "advective": a, "total": d + a}


def _flux_density(fq: FacetQuad, c: Function, u: Optional[Function], D):
    """(F,Q) local signed flux density J.n at facet quad points."""
    gq = fq.eval_grad(c.values)
    q = -D * jnp.einsum("fqa,fa->fq", gq, fq.normal)
    if u is not None:
        uq = fq.eval_vector(u.values, u.space)
        un = jnp.einsum("fqa,fa->fq", uq, fq.normal)
        q = q + un * fq.eval(c.values)
    return q


def compute_sulcus_segment_fluxes(c, u, mesh: MeshData, D, degree=4,
                                  warn=True):
    """Full sulcus flux bookkeeping (ref analysis.py:181-298).

    Returns the same keys: bottom_left / sulcus / bottom_right /
    sulcus_opening / sulcus_opening_extra / y0_flux / bottom_combined /
    y0_combined.
    """
    fluxes = {}
    # 1) external bottom segments
    for name in ("bottom_left", "sulcus", "bottom_right"):
        fq = boundary_quad(c.space, mesh.bottom_marker == MARKERS[name],
                           degree)
        if fq is None:
            fluxes[name] = {"diffusive": 0.0, "advective": 0.0, "total": 0.0}
            continue
        d, a = physical_flux_facets(fq, c, u, D)
        fluxes[name] = {"diffusive": d, "advective": a, "total": d + a}

    # 2) interior mouth, channel-side trace
    mq = mouth_quad(c.space, degree)
    if mq is not None:
        gq = mq.eval_grad(c.values)
        diff_density = -D * jnp.einsum("fqa,fa->fq", gq, mq.normal)
        J_open_diff = float(mq.integrate(diff_density))
        if u is not None:
            uq = mq.eval_vector(u.values, u.space)
            un = jnp.einsum("fqa,fa->fq", uq, mq.normal)
            adv_density = un * mq.eval(c.values)
            J_open_adv = float(mq.integrate(adv_density))
            q_open = diff_density + adv_density
        else:
            J_open_adv = 0.0
            q_open = diff_density
        E_L1 = float(mq.integrate(jnp.abs(q_open)))
        Q_in = float(mq.integrate(jnp.maximum(q_open, 0.0)))
        Q_out = float(mq.integrate(jnp.maximum(-q_open, 0.0)))
        L_sig = float(mq.total_length)
    else:
        J_open_diff = J_open_adv = E_L1 = Q_in = Q_out = 0.0
        L_sig = 0.0

    fluxes["sulcus_opening"] = {
        "diffusive": J_open_diff,
        "advective": J_open_adv,
        "total": J_open_diff + J_open_adv,
    }
    fluxes["sulcus_opening_extra"] = {
        "E_L1": E_L1,
        "E_avg": E_L1 / L_sig if L_sig > 0 else 0.0,
        "Q_in": Q_in,
        "Q_out": Q_out,
        "net_check": Q_in - Q_out,
        "length": L_sig,
    }

    # 3) one-shot full y=0 flux: exterior (flat) + interior (mouth)
    fq_y0 = boundary_quad(c.space, mesh.y0_marker == MARKERS["y0_line"],
                          degree)
    if fq_y0 is not None:
        d_ext, a_ext = physical_flux_facets(fq_y0, c, u, D)
    else:
        d_ext = a_ext = 0.0
    fluxes["y0_flux"] = {
        "diffusive": d_ext + J_open_diff,
        "advective": a_ext + J_open_adv,
        "total": d_ext + J_open_diff + a_ext + J_open_adv,
    }

    # 4) combined identities
    def _sum(keys):
        return {f: sum(fluxes[k][f] for k in keys)
                for f in ("diffusive", "advective", "total")}

    fluxes["bottom_combined"] = _sum(["bottom_left", "sulcus", "bottom_right"])
    fluxes["y0_combined"] = _sum(
        ["bottom_left", "bottom_right", "sulcus_opening"])

    # 5) consistency check (ref analysis.py:294-296).  NOTE: like in the
    # reference, y0_combined misses the two corner-adjacent flat facets that
    # the strict-inequality markers 5/7 exclude, so this generally differs at
    # O(h * flux density); we report it rather than assert.
    diff_val = abs(fluxes["y0_flux"]["total"] - fluxes["y0_combined"]["total"])
    fluxes["_y0_identity_gap"] = diff_val
    if warn and diff_val > 1e-10:
        print(f"y0_flux vs y0_combined differ by {diff_val:.3e} "
              "(corner-facet marker exclusion; matches reference behaviour)")
    return fluxes


def _mu_density(fq: FacetQuad, c: Function, mu):
    cq = fq.eval(c.values)
    if np.isscalar(mu):
        return float(mu) * cq
    mu_q = jnp.asarray(np.asarray(mu(fq.x[:, :, 0]), dtype=np.float64))
    return mu_q * cq


def compute_uptake_flux_bottom(c, mesh: MeshData, mu, degree=4):
    """int mu c ds over the whole bottom (marker 4) (ref analysis.py:307)."""
    fq = boundary_quad(c.space, mesh.bc_marker == MARKERS["bottom"], degree)
    if fq is None:
        return 0.0
    return float(fq.integrate(_mu_density(fq, c, mu)))


def compute_uptake_flux_segments(c, mesh: MeshData, mu, degree=4):
    """Per-segment Robin uptake flux (ref analysis.py:313-333)."""
    out = {}
    total = 0.0
    for name in ("bottom_left", "sulcus", "bottom_right"):
        fq = boundary_quad(c.space, mesh.bottom_marker == MARKERS[name],
                           degree)
        val = float(fq.integrate(_mu_density(fq, c, mu))) if fq else 0.0
        out[name] = val
        total += val
    out["total"] = total
    return out


def compute_flux_metrics(c, u, mesh: MeshData, domain_type, D, mu,
                         degree=4, warn=True):
    """Top-level flux metrics dict (ref analysis.py:640-675)."""
    metrics = {
        "physical_flux": {
            name: compute_physical_flux_boundary(
                c, u, mesh, MARKERS[name], D, degree)
            for name in ("left", "right", "top", "bottom")
        },
        "uptake_flux": compute_uptake_flux_bottom(c, mesh, mu, degree),
    }
    if domain_type == "sulcus":
        metrics["sulcus_specific"] = {
            "physical_flux": compute_sulcus_segment_fluxes(
                c, u, mesh, D, degree, warn=warn),
            "uptake_flux": compute_uptake_flux_segments(c, mesh, mu, degree),
        }
    return metrics
