"""Two-level (coarse-grid) preconditioner for the transport systems.

Jacobi-CG iteration counts on the study meshes grow like 1/h (thousands at
h=0.02); a two-level additive preconditioner

    M^{-1} = theta * D^{-1}  +  P A_c^{-1} P^T

cuts them by an order of magnitude.  Design choices:

  - the coarse space is P1 on an independently generated coarse mesh of the
    SAME geometry (rediscretised coarse operator, not Galerkin), so A_c
    assembles through the exact same batched element pipeline;
  - interpolation P is barycentric point-location of the fine dof
    coordinates in the coarse mesh: 3 gathers + weights per fine dof
    (built host-side once per mesh pair);
  - A_c is small (coarsening factor ~4 in h => ~2% of fine dofs), so
    A_c^{-1} is a batched DENSE Cholesky factorisation (one per sweep
    column, since A_c depends on the sweep coefficients D, mu) applied as
    batched triangular solves -- dense work instead of sparse
    iteration.

The preconditioner is SPD (additive combination of SPD terms), valid for
CG; for the mildly nonsymmetric advdiff systems the same M is used with
BiCGStab (the advection term is omitted from A_c's symmetric part only at
high Pe; at the study's Pe <= 10 including it rediscretised is fine).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["TwoLevelData", "build_twolevel", "make_preconditioner"]


class TwoLevelData(NamedTuple):
    cols: jnp.ndarray        # (n_fine, 3) coarse vertex ids
    weights: jnp.ndarray     # (n_fine, 3) barycentric weights
    perm: jnp.ndarray        # scatter plan for P^T
    ids_sorted: jnp.ndarray
    n_coarse: int
    # general path: per-sample explicit inverses (B, nc, nc); or the
    # Woodbury path (constant D, scalar mu): A_b = A0 + mu_b W W^T with
    # shared A0inv (nc, nc), Z = A0inv W (nc, r), and per-sample
    # capacitance inverses C_b = (I/mu_b + W^T Z)^{-1} (B, r, r)
    Ainv: "object"           # (B, nc, nc) f32, or None on Woodbury path
    A0inv: "object"          # (nc, nc) f32, or None
    Z: "object"              # (nc, r) f32, or None
    W: "object"              # (nc, r) f32, or None
    Cinv: "object"           # (B, r, r) f32, or None
    theta: float


def _interpolation(fine_coords, coarse_mesh, free_fine):
    """Barycentric interpolation data fine<-coarse (host)."""
    from ..analysis.profiles import PointLocator
    loc = PointLocator(coarse_mesh, k=12, tol=1e-8)
    cells, ref = loc.locate(fine_coords)
    # points that fall outside the coarse mesh (curved boundary gaps):
    # snap to nearest coarse vertex
    bad = cells < 0
    lam = np.concatenate([1 - ref.sum(1, keepdims=True), ref], axis=1)
    lam = np.clip(lam, 0.0, 1.0)
    lam /= np.maximum(lam.sum(1, keepdims=True), 1e-300)
    cols = coarse_mesh.cells[np.where(bad, 0, cells)]      # (n,3)
    if bad.any():
        from scipy.spatial import cKDTree
        tree = cKDTree(coarse_mesh.vertices)
        _, nearest = tree.query(fine_coords[bad])
        cols[bad] = np.stack([nearest] * 3, axis=1)
        lam[bad] = np.array([1.0, 0.0, 0.0])
    # constrained fine dofs take no coarse correction
    lam[~np.asarray(free_fine)] = 0.0
    return cols.astype(np.int64), lam


def build_twolevel(sys, coarse_mesh, D_values, mu_values=None,
                   robin_matrices_coarse=None, u_coarse=None,
                   theta=0.6):
    """Build two-level data for a TransportSystem sweep.

    sys: fine TransportSystem (parallel/sweep.py)
    coarse_mesh: MeshData of the same geometry, coarser h
    D_values/mu_values: the sweep coefficients (determine A_c per column)
    u_coarse: optional (values, space) velocity on the coarse mesh
    """
    from ..parallel.sweep import build_transport_system
    from ..fem.assembly import make_bc
    from ..meshing.mesh_data import MARKERS

    D_vec = np.asarray(D_values, dtype=np.float64)
    B = len(D_vec)
    mu_vec = (np.zeros(B) if mu_values is None
              else np.asarray(mu_values, dtype=np.float64))

    # the coarse system is densified: bucketing padding would blow the
    # dense inverse up to the padded size -- never pad here
    if u_coarse is None:
        csys = build_transport_system(coarse_mesh, element="P1",
                                      pad_shapes=False)
    else:
        csys = build_transport_system(coarse_mesh, element="P1",
                                      u_values=u_coarse[0],
                                      u_space=u_coarse[1],
                                      pad_shapes=False)
    nc = csys.ndofs

    # dense coarse matrices per sweep column
    from ..ops.elemspmv import SumOperator, ElementBlock

    def dense_of(block, A_e):
        M = np.zeros((nc, nc))
        dofs = np.asarray(block.dofs)
        Ae = np.asarray(A_e)
        for local in range(dofs.shape[1]):
            rows = dofs[:, local]
            for lj in range(dofs.shape[1]):
                np.add.at(M, (rows, dofs[:, lj]), Ae[:, local, lj])
        return M

    K_c = dense_of(csys.K, csys.K.A64)
    Adv_c = dense_of(csys.Adv, csys.Adv.A64) if csys.Adv is not None else 0.0
    R_c = dense_of(csys.R, csys.R.A64) if csys.R is not None else None

    free_c = np.asarray(csys.free)

    def constrain(A):
        A[~free_c, :] = 0.0
        A[:, ~free_c] = 0.0
        idx = np.flatnonzero(~free_c)
        A[idx, idx] = 1.0
        return A

    K_c = constrain(K_c)
    if csys.Adv is not None:
        Advsym = constrain(0.5 * (Adv_c + Adv_c.T))
    else:
        Advsym = None
    if R_c is not None:
        R_c = constrain(R_c)

    # coefficient combination + inversion on HOST (numpy): a one-time
    # setup cost.  f32 is plenty for a preconditioner.
    Ainv = A0inv = Z = W = Cinv = None
    same_D = np.allclose(D_vec, D_vec[0])
    import os as _os
    use_woodbury = _os.environ.get("FEU_WOODBURY", "0") == "1"
    # per-sample inverses are the default, Woodbury is opt-in.
    if (use_woodbury and same_D and robin_matrices_coarse is None
            and R_c is not None):
        # Woodbury path: A_b = A0 + mu_b R_c, ONE nc^3 inverse total.
        # Factor R_c = W W^T on its (small) support via eigh.
        sup = np.flatnonzero(np.abs(R_c).sum(0) > 0)
        r_sub = R_c[np.ix_(sup, sup)]
        evals, evecs = np.linalg.eigh(r_sub)
        keep = evals > max(evals.max(), 0) * 1e-10
        Wd = np.zeros((nc, int(keep.sum())))
        Wd[sup] = evecs[:, keep] * np.sqrt(evals[keep])[None, :]
        A0 = D_vec[0] * K_c
        if Advsym is not None:
            A0 = A0 + Advsym
        A0 = A0 + 1e-6 * np.abs(np.diag(A0)).mean() * np.eye(nc)
        A0inv_d = np.linalg.inv(A0.astype(np.float32)).astype(np.float64)
        Zd = A0inv_d @ Wd                                  # (nc, r)
        WtZ = Wd.T @ Zd                                    # (r, r)
        r_dim = Wd.shape[1]
        Cinvs = []
        for b in range(B):
            mu_b = max(mu_vec[b], 0.0)
            if mu_b == 0.0:
                Cinvs.append(np.zeros((r_dim, r_dim)))
            else:
                Cinvs.append(np.linalg.inv(
                    np.eye(r_dim) / mu_b + WtZ))
        A0inv = jnp.asarray(A0inv_d, dtype=jnp.float32)
        Z = jnp.asarray(Zd, dtype=jnp.float32)
        W = jnp.asarray(Wd, dtype=jnp.float32)
        Cinv = jnp.asarray(np.stack(Cinvs), dtype=jnp.float32)
    else:
        Ainvs = []
        for b in range(B):
            A = D_vec[b] * K_c
            if Advsym is not None:
                A = A + Advsym
            if R_c is not None:
                if robin_matrices_coarse is not None:
                    Rb = constrain(dense_of(csys.R,
                                            robin_matrices_coarse[b]))
                    A = A + Rb
                else:
                    A = A + mu_vec[b] * R_c
            A = A + 1e-6 * np.abs(np.diag(A)).mean() * np.eye(nc)
            Ainvs.append(np.linalg.inv(A.astype(np.float32)))
        Ainv = jnp.asarray(np.stack(Ainvs))               # (B, nc, nc) f32

    # interpolation from coarse P1 vertices to fine scalar dofs
    # (rows follow the fine system's dof order, incl. RCM renumbering)
    fine_coords = np.asarray(sys.space.dof_coords)
    if sys.perm is not None:
        fine_coords = fine_coords[np.asarray(sys.perm)[:len(fine_coords)]]
    n_true = len(fine_coords)
    cols, lam = _interpolation(fine_coords, coarse_mesh,
                               np.asarray(sys.free)[:n_true])
    # shape-bucketing padding dofs take no coarse correction
    if sys.ndofs > n_true:
        pad = sys.ndofs - n_true
        cols = np.concatenate([cols, np.zeros((pad, 3), np.int64)])
        lam = np.concatenate([lam, np.zeros((pad, 3))])
    ids = cols.ravel()
    perm = np.argsort(ids, kind="stable")
    return TwoLevelData(
        cols=jnp.asarray(cols, dtype=jnp.int32),
        weights=jnp.asarray(lam),
        perm=jnp.asarray(perm, dtype=jnp.int32),
        ids_sorted=jnp.asarray(ids[perm], dtype=jnp.int32),
        n_coarse=nc,
        Ainv=Ainv, A0inv=A0inv, Z=Z, W=W, Cinv=Cinv,
        theta=float(theta),
    )


def make_preconditioner(tl: TwoLevelData, dinv, f32=False):
    """M^{-1}: (n, B) -> (n, B), additive Jacobi + coarse correction.

    Returned as an (fn, args) pair (solvers/batched.py convention): the
    coarse inverses are hundreds of MB and must enter the jitted Krylov
    chunks as ARGUMENTS, not closure constants.
    """
    w32 = tl.weights.astype(jnp.float32)
    perm, ids_sorted, cols = tl.perm, tl.ids_sorted, tl.cols
    n_coarse, theta = tl.n_coarse, tl.theta
    woodbury = tl.Ainv is None

    def _restrict(w, Rw):
        contrib = w[:, :, None] * Rw[:, None, :]          # (n,3,B)
        n, _, B = contrib.shape
        flat = contrib.reshape(n * 3, B)[perm]
        return jax.ops.segment_sum(flat, ids_sorted,
                                   num_segments=n_coarse,
                                   indices_are_sorted=True)  # (nc,B)

    # matmul precision: default (bf16 passes) is fine in a preconditioner
    mm = dict(preferred_element_type=jnp.float32)

    if woodbury:
        args = (tl.A0inv, tl.Z, tl.W, tl.Cinv,
                dinv.astype(jnp.float32), w32)

        def apply(m_args, R):
            A0inv, Z, W, Cinv, dinv32, w = m_args
            Rw = R.astype(jnp.float32)
            rc = _restrict(w, Rw)
            y = A0inv @ rc                                 # (nc,B) shared
            t = W.T @ y                                    # (r,B)
            # per-sample capacitance solve as a leading-batch matmul
            u_b = jnp.matmul(Cinv, jnp.moveaxis(t, 1, 0)[..., None],
                             **mm)                         # (B,r,1)
            u = jnp.moveaxis(u_b[..., 0], 0, 1)            # (r,B)
            xc = y - Z @ u                                 # (nc,B)
            fine = jnp.einsum("nk,nkb->nb", w, xc[cols], **mm)
            return (theta * dinv32 * Rw + fine).astype(R.dtype)

        return (apply, args)

    args = (tl.Ainv, dinv.astype(jnp.float32), w32)

    def apply(m_args, R):
        Ainv, dinv32, w = m_args
        Rw = R.astype(jnp.float32)
        rc = _restrict(w, Rw)
        xc_b = jnp.matmul(Ainv, jnp.moveaxis(rc, 1, 0)[..., None],
                          **mm)                            # (B,nc,1)
        xc = jnp.moveaxis(xc_b[..., 0], 0, 1)              # (nc,B)
        fine = jnp.einsum("nk,nkb->nb", w, xc[cols], **mm)
        return (theta * dinv32 * Rw + fine).astype(R.dtype)

    return (apply, args)
