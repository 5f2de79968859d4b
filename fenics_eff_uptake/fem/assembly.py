"""Batched element assembly on device.

Replaces the UFL/FFC form compiler + dolfin assembler (ref solvers.py:43-48,
78-79, 140-147, 204-209, 291-294): the form set of the study is small and
fixed, so each weak-form term is a hand-written vmapped quadrature loop that
emits per-entity dense matrices for ops.elemspmv.

Quadrature degrees follow FFC's estimates for the reference forms:
  stiffness (P2xP2 grads)     -> degree 2
  mass / Robin facet          -> degree 4
  advection (P2 u, P2 c)      -> degree 5
Variable-mu Robin facets use a 6-point 1-D Gauss rule (the smoothed step is
not polynomial; matches/not-worse-than dolfin's estimate).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.elemspmv import ElementBlock, SumOperator
from ..params import StepUptakeOpen
from .elements import _EDGE_VERTS, _REF_VERTS, tabulate, tabulate_grad
from .quadrature import interval_rule, triangle_rule
from .space import FunctionSpace

__all__ = [
    "cell_geometry", "stiffness_block", "mass_block", "advection_block",
    "robin_facet_block", "load_vector", "BCData", "make_bc",
    "constrained_operator", "constrained_rhs",
]


def _f(x):
    return jnp.asarray(x)


def cell_geometry(vertices, cells):
    """Per-cell affine map data: detJ (T,), invJT (T,2,2)."""
    p = vertices[cells]                       # (T,3,2)
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    detJ = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    inv = jnp.stack([
        jnp.stack([d2[:, 1], -d2[:, 0]], axis=-1),
        jnp.stack([-d1[:, 1], d1[:, 0]], axis=-1),
    ], axis=1) / detJ[:, None, None]          # inv(J), rows
    invJT = jnp.swapaxes(inv, 1, 2)
    return detJ, invJT


def _padded_cell_arrays(space: FunctionSpace, pad):
    """Host-pad (vertices, cells, cell_dofs) to the bucket shapes so the
    device assembly einsums compile ONCE per shape class instead of once
    per geometry (each raw mesh has a unique cell/vertex count; measured
    ~35 fresh XLA compiles = ~50 s per NEW geometry without this).

    Dummy cells reference 3 appended unit-triangle vertices (detJ = 1,
    so the affine inverse stays finite) and scatter into the dummy dof;
    their element matrices are zeroed by the returned mask."""
    T_pad, ndofs_p, dummy, V_pad = pad
    mesh = space.mesh
    V = len(mesh.vertices)
    T = len(mesh.cells)
    verts = np.concatenate([
        np.asarray(mesh.vertices),
        np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
        np.zeros((V_pad - V - 3, 2))])
    cells = np.concatenate([
        np.asarray(mesh.cells),
        np.tile([V, V + 1, V + 2], (T_pad - T, 1))]).astype(np.int64)
    cd = np.concatenate([
        np.asarray(space.cell_dofs),
        np.full((T_pad - T, space.nd_local), dummy)]).astype(np.int64)
    mask = np.zeros(T_pad)
    mask[:T] = 1.0
    return verts, cells, cd, mask, ndofs_p


# ---------------------------------------------------------------------------
# fused device kernels
#
# Each block builder's device computation is ONE jitted program.  The
# eager op-by-op path issued ~130 tiny dispatches per fresh assembly.
# Tabulation tables and quadrature weights travel as traced
# arguments, so one compiled program serves every mesh in a shape bucket.
# ---------------------------------------------------------------------------


@jax.jit
def _stiffness_dev(verts, cells, qw, gref, mask, d):
    detJ, invJT = cell_geometry(verts, cells)
    G = jnp.einsum("tab,qib->tqia", invJT, gref)
    K = jnp.einsum("q,tqia,tqja,t->tij", qw, G, G, detJ) * d
    if mask is not None:
        K = K * mask[:, None, None]
    return K


@jax.jit
def _mass_dev(verts, cells, qw, phi, mask, coeff):
    detJ, _ = cell_geometry(verts, cells)
    M = jnp.einsum("q,qi,qj,t->tij", qw, phi, phi, detJ) * coeff
    if mask is not None:
        M = M * mask[:, None, None]
    return M


@jax.jit
def _advection_dev(verts, cells, qw, phi, gref, phi_u, u_flat, ucd, mask):
    detJ, invJT = cell_geometry(verts, cells)
    G = jnp.einsum("tab,qib->tqia", invJT, gref)
    u_cell = u_flat[ucd]
    u_cell = u_cell.reshape(u_cell.shape[0], -1, 2)
    u_q = jnp.einsum("qk,tka->tqa", phi_u, u_cell)
    A = jnp.einsum("q,qi,tqa,tqja,t->tij", qw, phi, u_q, G, detJ)
    if mask is not None:
        A = A * mask[:, None, None]
    return A


@jax.jit
def _robin_dev(w, mu_q, tabs, le, lens):
    phi_f = tabs[le]
    return jnp.einsum("q,fq,fqi,fqj,f->fij", w, mu_q, phi_f, phi_f, lens)


@jax.jit
def _vector_stiffness_dev(verts, cells, qw, gref, coeff):
    detJ, invJT = cell_geometry(verts, cells)
    G = jnp.einsum("tab,qib->tqia", invJT, gref)
    K = jnp.einsum("q,tqia,tqja,t->tij", qw, G, G, detJ) * coeff
    T, nd, _ = K.shape
    A = jnp.zeros((T, 2 * nd, 2 * nd), dtype=K.dtype)
    A = A.at[:, 0::2, 0::2].set(K)
    A = A.at[:, 1::2, 1::2].set(K)
    return A


@jax.jit
def _divergence_dev(verts, cells, qw, psi, gref, mask):
    detJ, invJT = cell_geometry(verts, cells)
    G = jnp.einsum("tab,qib->tqia", invJT, gref)
    Bd = jnp.einsum("q,qk,tqjb,t->tkjb", qw, psi, G, detJ)
    T, npp, ndu, _ = Bd.shape
    B = -Bd.reshape(T, npp, 2 * ndu)
    if mask is not None:
        B = B * mask[:, None, None]
    return B


def stiffness_block(space: FunctionSpace, D=1.0, degree=2,
                    pad=None) -> ElementBlock:
    """K_e[i,j] = D * int grad(phi_i).grad(phi_j) dx  (ref solvers.py:140).

    pad: optional (T_pad, ndofs_pad, dummy_dof, V_pad) -- assemble at
    bucketed shapes (see _padded_cell_arrays)."""
    mesh = space.mesh
    if pad is None:
        verts = _f(mesh.vertices)
        cells = jnp.asarray(mesh.cells)
        cd, mask, ndofs = space.cell_dofs, None, space.ndofs
    else:
        vh, ch, cd, mh, ndofs = _padded_cell_arrays(space, pad)
        verts, cells, mask = _f(vh), jnp.asarray(ch), _f(mh)
    qp, qw = triangle_rule(degree)
    gref = tabulate_grad(space.element, qp)
    K = _stiffness_dev(verts, cells, _f(qw), _f(gref), mask,
                       jnp.asarray(float(D)))
    return ElementBlock.build(K, cd, ndofs)


def mass_block(space: FunctionSpace, coeff=1.0, degree=4,
               pad=None) -> ElementBlock:
    mesh = space.mesh
    if pad is None:
        verts = _f(mesh.vertices)
        cells = jnp.asarray(mesh.cells)
        cd, mask, ndofs = space.cell_dofs, None, space.ndofs
    else:
        vh, ch, cd, mh, ndofs = _padded_cell_arrays(space, pad)
        verts, cells, mask = _f(vh), jnp.asarray(ch), _f(mh)
    qp, qw = triangle_rule(degree)
    phi = tabulate(space.element, qp)     # (Q,nd)
    M = _mass_dev(verts, cells, _f(qw), _f(phi), mask,
                  jnp.asarray(float(coeff)))
    return ElementBlock.build(M, cd, ndofs)


def advection_block(space: FunctionSpace, u_values, u_space: FunctionSpace,
                    degree=5, pad=None) -> ElementBlock:
    """A_e[i,j] = int (u . grad(phi_j)) phi_i dx  (ref solvers.py:43-44).

    ``u_values`` are interleaved vector dofs on ``u_space`` (same mesh).
    pad: optional (T_pad, ndofs_pad, dummy_dof, V_pad) bucket shapes.
    """
    mesh = space.mesh
    if pad is None:
        verts = _f(mesh.vertices)
        cells = jnp.asarray(mesh.cells)
        cd, mask, ndofs = space.cell_dofs, None, space.ndofs
        ucd = np.asarray(u_space.cell_dofs)
        u_flat = u_values
    else:
        vh, ch, cd, mh, ndofs = _padded_cell_arrays(space, pad)
        verts, cells, mask = _f(vh), jnp.asarray(ch), _f(mh)
        T = len(mesh.cells)
        ucd = np.concatenate([
            np.asarray(u_space.cell_dofs),
            np.zeros((pad[0] - T, u_space.cell_dofs.shape[1]),
                     dtype=np.int64)])
        # pad u host-side to a fixed-granularity bucket so the gather
        # source shape is shared across geometries (u_space can be a
        # larger space than `space`, e.g. P2 velocity on a P1 level)
        u_raw = np.asarray(u_values).ravel()
        u_np = np.zeros(-(-len(u_raw) // 16384) * 16384)
        u_np[:len(u_raw)] = u_raw
        u_flat = _f(u_np)
    qp, qw = triangle_rule(degree)
    phi = tabulate(space.element, qp)         # (Q,nd)
    gref = tabulate_grad(space.element, qp)   # (Q,nd,2)
    phi_u = tabulate(u_space.element, qp)     # (Q,ndu)
    A = _advection_dev(verts, cells, _f(qw), _f(phi), _f(gref),
                       _f(phi_u), _f(u_flat), jnp.asarray(ucd), mask)
    return ElementBlock.build(A, cd, ndofs)


def vector_stiffness_block(vspace: FunctionSpace, coeff=1.0,
                           degree=2) -> ElementBlock:
    """A_e for the vector Laplacian int grad(u):grad(v) dx (ref
    solvers.py:291): interleaved layout, A = kron(K_scalar, I_2)."""
    mesh = vspace.mesh
    verts = _f(mesh.vertices)
    cells = jnp.asarray(mesh.cells)
    qp, qw = triangle_rule(degree)
    gref = tabulate_grad(vspace.element, qp)
    A = _vector_stiffness_dev(verts, cells, _f(qw), _f(gref),
                              jnp.asarray(float(coeff)))
    return ElementBlock.build(A, vspace.cell_dofs, vspace.ndofs)


def divergence_block(pspace: FunctionSpace, vspace: FunctionSpace,
                     degree=3, pad=None):
    """B_e[k,(j,b)] = -int psi_k d_b(phi_j) dx -- the coupling B = -B_div so
    that the saddle matrix [[A, B^T],[B, 0]] matches the reference form
    a = grad(u):grad(v) - p div v - q div u (ref solvers.py:291-293).

    pad: optional (T_pad, V_pad) -- assemble at bucketed cell/vertex
    shapes (dummy cells reference appended unit-triangle vertices, get
    zeroed matrices, and scatter into dof 0 -- a no-op)."""
    from ..ops.elemspmv import RectBlock
    mesh = vspace.mesh
    if pad is None:
        verts = _f(mesh.vertices)
        cells = jnp.asarray(mesh.cells)
        rd, cdv, mask = pspace.cell_dofs, vspace.cell_dofs, None
    else:
        T_pad, V_pad = pad
        V = len(mesh.vertices)
        T = len(mesh.cells)
        vh = np.concatenate([
            np.asarray(mesh.vertices),
            np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
            np.zeros((V_pad - V - 3, 2))])
        ch = np.concatenate([
            np.asarray(mesh.cells),
            np.tile([V, V + 1, V + 2], (T_pad - T, 1))]).astype(np.int64)
        rd = np.concatenate([
            np.asarray(pspace.cell_dofs),
            np.zeros((T_pad - T, pspace.nd_local), dtype=np.int64)])
        cdv = np.concatenate([
            np.asarray(vspace.cell_dofs),
            np.zeros((T_pad - T, vspace.cell_dofs.shape[1]),
                     dtype=np.int64)])
        mh = np.zeros(T_pad)
        mh[:T] = 1.0
        verts, cells, mask = _f(vh), jnp.asarray(ch), _f(mh)
    qp, qw = triangle_rule(degree)
    psi = tabulate(pspace.element, qp)            # (Q,np)
    gref = tabulate_grad(vspace.element, qp)      # (Q,ndu,2)
    # interleaved velocity layout: col (2j+b); the kernel's reshape gives
    # (j,b) pairs in exactly that order since b is the fastest axis.
    B = _divergence_dev(verts, cells, _f(qw), _f(psi), _f(gref), mask)
    return RectBlock.build(B, rd, cdv, pspace.ndofs, vspace.ndofs)


# ---------------------------------------------------------------------------
# facet (boundary) terms
# ---------------------------------------------------------------------------

def _facet_data(space: FunctionSpace, facet_mask):
    """Per-selected-facet arrays: owning cell dofs, local-edge id, endpoints."""
    mesh = space.mesh
    fs = mesh.boundary
    sel = np.flatnonzero(facet_mask)
    cells_f = fs.cell[sel]
    le = fs.local_edge[sel]
    lv = _EDGE_VERTS_ARR[le]                      # (F,2) local vertex ids
    ga = mesh.cells[cells_f, lv[:, 0]]
    gb = mesh.cells[cells_f, lv[:, 1]]
    return sel, cells_f, le, ga, gb


_EDGE_VERTS_ARR = np.array([_EDGE_VERTS[i] for i in range(3)])


def _edge_tables(element, t):
    """Basis values along each of the 3 local edges at params t: (3,Q,nd)."""
    tabs = []
    for le in range(3):
        a, b = _EDGE_VERTS[le]
        pts = ((1.0 - t)[:, None] * _REF_VERTS[a]
               + t[:, None] * _REF_VERTS[b])
        tabs.append(tabulate(element, pts))
    return np.stack(tabs, axis=0)


def robin_facet_block(space: FunctionSpace, facet_mask,
                      mu: Union[float, StepUptakeOpen, Callable],
                      degree=4, pad=None) -> ElementBlock:
    """R_f[i,j] = int_f mu(x) phi_i phi_j ds  (ref solvers.py:48,79,144,208).

    mu may be a scalar or a vectorised callable of x (e.g. StepUptakeOpen);
    callables are evaluated at all facet quadrature points in one shot,
    replacing the reference's per-point UserExpression callback
    (parameters.py:74-81).
    pad: optional (F_pad, ndofs_pad, dummy_dof) bucket shapes.
    """
    mesh = space.mesh
    if not np.isscalar(mu):
        degree = max(degree, 6)
    t, w = interval_rule(degree)
    sel, cells_f, le, ga, gb = _facet_data(space, facet_mask)
    va = mesh.vertices[ga]                         # (F,2)
    vb = mesh.vertices[gb]
    lens = np.linalg.norm(vb - va, axis=1)
    xq = (1.0 - t)[None, :, None] * va[:, None, :] \
        + t[None, :, None] * vb[:, None, :]        # (F,Q,2)
    if np.isscalar(mu):
        mu_q = np.full(xq.shape[:2], float(mu))
    else:
        mu_q = np.asarray(mu(xq[:, :, 0]), dtype=np.float64)
        # clamp to nonnegative like pure_diffusion_solver_variable_mu
        # (ref solvers.py:204)
        mu_q = np.maximum(mu_q, 0.0)
    fdofs = np.asarray(space.cell_dofs)[cells_f]   # (F,nd)
    ndofs = space.ndofs
    if pad is not None:
        # host-pad the facet arrays to the bucket: padding rows have
        # zero edge length (-> exactly-zero matrices) and scatter into
        # the dummy dof, so the device einsum compiles once per class
        F_pad, ndofs, dummy = pad
        padF = F_pad - len(sel)
        le = np.concatenate([le, np.zeros(padF, dtype=le.dtype)])
        lens = np.concatenate([lens, np.zeros(padF)])
        mu_q = np.concatenate(
            [mu_q, np.zeros((padF,) + mu_q.shape[1:])])
        fdofs = np.concatenate(
            [fdofs, np.full((padF, fdofs.shape[1]), dummy)])
    tabs = _edge_tables(space.element, t)          # (3,Q,nd)
    R = _robin_dev(_f(w), _f(mu_q), _f(tabs), jnp.asarray(le),
                   _f(lens))
    return ElementBlock.build(R, fdofs, ndofs)


def load_vector(space: FunctionSpace, f_callable, degree=4):
    """b_i = int f(x) phi_i dx  (tests/MMS only; reference RHS is zero)."""
    mesh = space.mesh
    verts = _f(mesh.vertices)
    cells = jnp.asarray(mesh.cells)
    detJ, _ = cell_geometry(verts, cells)
    qp, qw = triangle_rule(degree)
    phi = _f(tabulate(space.element, qp))
    p = mesh.vertices[mesh.cells]                  # (T,3,2) host
    lam = np.concatenate(
        [1 - qp.sum(1, keepdims=True), qp], axis=1)  # (Q,3) barycentric
    xq = np.einsum("qv,tva->tqa", lam, p)          # (T,Q,2)
    fq = _f(np.asarray(f_callable(xq[..., 0], xq[..., 1]), dtype=np.float64))
    be = jnp.einsum("q,tq,qi,t->ti", _f(qw), fq, phi, detJ)
    b = jnp.zeros(space.ndofs, dtype=be.dtype)
    return b.at[jnp.asarray(space.cell_dofs).reshape(-1)].add(be.reshape(-1))


# ---------------------------------------------------------------------------
# Dirichlet constraints (symmetric elimination, dolfin-style)
# ---------------------------------------------------------------------------

@dataclass
class BCData:
    free: jnp.ndarray      # (ndofs,) bool
    values: jnp.ndarray    # (ndofs,) bc value where constrained, else 0


def make_bc(space: FunctionSpace, marker_value_pairs, marker_array=None) -> BCData:
    """Dirichlet data from (marker_id, value) pairs on bc markers.

    Matches ``DirichletBC(C, Constant(v), bc_markers, id)``
    (ref solvers.py:30-31,127-128).
    """
    mesh = space.mesh
    marker = mesh.bc_marker if marker_array is None else marker_array
    free = np.ones(space.ndofs, dtype=bool)
    vals = np.zeros(space.ndofs)
    for marker_id, value in marker_value_pairs:
        dofs = space.boundary_scalar_dofs(marker == marker_id)
        if space.vs == 1:
            gdofs = dofs
        else:
            gdofs = np.concatenate([2 * dofs, 2 * dofs + 1])
        free[gdofs] = False
        if np.isscalar(value):
            vals[gdofs] = value
        else:
            # value = callable(x, y) -> (len(dofs), vs)
            coords = space.dof_coords[dofs]
            v = np.asarray(value(coords[:, 0], coords[:, 1]))
            if space.vs == 1:
                vals[gdofs] = v
            else:
                vals[2 * dofs] = v[:, 0]
                vals[2 * dofs + 1] = v[:, 1]
    return BCData(free=jnp.asarray(free), values=jnp.asarray(vals))


def constrained_operator(op: SumOperator, bc: BCData):
    """x -> A x restricted to free dofs; identity on constrained dofs."""

    def apply(x):
        x0 = jnp.where(bc.free, x, 0.0)
        y = op.apply(x0)
        return jnp.where(bc.free, y, x)

    return apply


def constrained_rhs(op: SumOperator, bc: BCData, b=None):
    """RHS for the eliminated system: b - A g on free dofs, g on bc dofs."""
    Ag = op.apply(bc.values)
    if b is None:
        b = jnp.zeros_like(bc.values)
    return jnp.where(bc.free, b - Ag, bc.values)
