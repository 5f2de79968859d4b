"""Facet quadrature evaluation: values, gradients, normals on facet sets.

The engine behind every boundary/interface integral in the analysis layer
(the reference's ``assemble(expr * ds(marker))`` / ``dS`` calls,
analysis.py:55-298).  All selected facets are evaluated in one batched shot:
basis tables are precomputed per local edge, gathered per facet, and reduced
with einsums -- no per-facet Python.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..fem.elements import _EDGE_VERTS, _REF_VERTS, tabulate, tabulate_grad
from ..fem.quadrature import interval_rule
from ..fem.space import FunctionSpace

__all__ = ["FacetQuad", "build_facet_quad"]

_CYC_A = np.array([1, 2, 0])
_CYC_B = np.array([2, 0, 1])


def _edge_ref_points(t):
    """Reference-coordinate quad points along each local edge: (3,Q,2)."""
    pts = []
    for le in range(3):
        a, b = _EDGE_VERTS[le]
        pts.append((1.0 - t)[:, None] * _REF_VERTS[a]
                   + t[:, None] * _REF_VERTS[b])
    return np.stack(pts, axis=0)


@dataclass
class FacetQuad:
    """Batched quadrature data for a set of facets (one side).

    Shapes: F facets, Q quad points, nd local dofs of the space.
    """

    cells: jnp.ndarray        # (F,)
    phi: jnp.ndarray          # (F,Q,nd) basis values
    grad: jnp.ndarray         # (F,Q,nd,2) physical basis gradients
    x: np.ndarray             # (F,Q,2) physical quad points (host)
    normal: jnp.ndarray       # (F,2) outward unit normal of the owning cell
    length: jnp.ndarray       # (F,)
    qw: jnp.ndarray           # (Q,)
    cell_dofs: jnp.ndarray    # (F,nd)

    def eval(self, values):
        """Scalar field at quad points: (F,Q)."""
        ce = values[self.cell_dofs]
        return jnp.einsum("fqi,fi->fq", self.phi, ce)

    def eval_grad(self, values):
        """Scalar field gradient at quad points: (F,Q,2)."""
        ce = values[self.cell_dofs]
        return jnp.einsum("fqia,fi->fqa", self.grad, ce)

    def eval_vector(self, values, vspace: FunctionSpace):
        """Interleaved vector field at quad points: (F,Q,2)."""
        vd = jnp.asarray(vspace.cell_dofs)[self.cells]       # (F,2*nd)
        ce = values[vd].reshape(vd.shape[0], -1, 2)           # (F,nd,2)
        return jnp.einsum("fqi,fia->fqa", self.phi, ce)

    def integrate(self, density):
        """sum_f length_f * sum_q w_q density[f,q]  (density (F,Q))."""
        return jnp.einsum("q,fq,f->", self.qw, density, self.length)

    def integrate_per_facet(self, density):
        return jnp.einsum("q,fq,f->f", self.qw, density, self.length)

    @property
    def total_length(self):
        return jnp.sum(self.length)


def build_facet_quad(space: FunctionSpace, cells_f, local_edges,
                     degree=4, flip_normal=False) -> FacetQuad:
    """Build facet quadrature data for facets given as (cell, local_edge).

    The normal is the outward normal of the owning cell (CCW convention);
    ``flip_normal`` flips it (used for '-'-side conventions).
    """
    mesh = space.mesh
    cells_f = np.asarray(cells_f, dtype=np.int64)
    le = np.asarray(local_edges, dtype=np.int64)
    t, w = interval_rule(degree)

    # basis tables per local edge
    tabs = []
    gtabs = []
    refpts = _edge_ref_points(t)
    for k in range(3):
        tabs.append(tabulate(space.element, refpts[k]))
        gtabs.append(tabulate_grad(space.element, refpts[k]))
    tabs = np.stack(tabs)    # (3,Q,nd)
    gtabs = np.stack(gtabs)  # (3,Q,nd,2)

    # all table-building stays in host NumPy: every mesh has unique facet
    # counts, so eager jnp gathers here would trigger fresh XLA compiles
    # per geometry (measured ~85 compiles = 3-9 s/geometry host-side)
    phi = tabs[le]                                   # (F,Q,nd)
    gref = gtabs[le]                                 # (F,Q,nd,2)

    pv = np.asarray(mesh.vertices)[np.asarray(mesh.cells)[cells_f]]
    d1 = pv[:, 1] - pv[:, 0]
    d2 = pv[:, 2] - pv[:, 0]
    detJ = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    inv = np.stack([
        np.stack([d2[:, 1], -d2[:, 0]], axis=-1),
        np.stack([-d1[:, 1], d1[:, 0]], axis=-1),
    ], axis=1) / detJ[:, None, None]
    invJT_f = np.swapaxes(inv, 1, 2)                 # (F,2,2)
    grad = np.einsum("fab,fqib->fqia", invJT_f, gref)

    # geometry: endpoints in _EDGE_VERTS order for x; cyclic order for normal
    lv = np.array([_EDGE_VERTS[i] for i in range(3)])[le]    # (F,2)
    ga = mesh.cells[cells_f, lv[:, 0]]
    gb = mesh.cells[cells_f, lv[:, 1]]
    va, vb = mesh.vertices[ga], mesh.vertices[gb]
    x = ((1.0 - t)[None, :, None] * va[:, None, :]
         + t[None, :, None] * vb[:, None, :])

    ca = mesh.cells[cells_f, _CYC_A[le]]
    cb = mesh.cells[cells_f, _CYC_B[le]]
    d = mesh.vertices[cb] - mesh.vertices[ca]
    lens = np.linalg.norm(d, axis=1)
    n = np.stack([d[:, 1], -d[:, 0]], axis=1) / np.maximum(
        lens[:, None], 1e-300)
    if flip_normal:
        n = -n

    return FacetQuad(
        cells=jnp.asarray(cells_f),
        phi=jnp.asarray(phi), grad=jnp.asarray(grad), x=x,
        normal=jnp.asarray(n),
        length=jnp.asarray(lens),
        qw=jnp.asarray(w),
        cell_dofs=jnp.asarray(np.asarray(space.cell_dofs)[cells_f]),
    )
