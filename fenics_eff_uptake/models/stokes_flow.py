"""Stokes flow: Taylor-Hood, Poiseuille inlet, no-slip walls, free outlet.

JAX equivalent of ``stokes_solver`` / ``stokes_solver_no_adv``
(ref solvers.py:237-315):

  spaces : u in vector P2, p in P1 (Taylor-Hood; ref simulation.py:128-130)
  BCs    : u = (4 y (H - y), 0) on left (marker 1)  [ref solvers.py:254-258]
           u = 0 on top (3) and bottom (4)          [ref solvers.py:259-264]
           natural (do-nothing) outflow on right -- which also fixes the
           pressure level; the reference's pointwise outlet pin is a no-op
           under legacy dolfin semantics (see solvers/stokes.py docstring).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.assembly import (divergence_block, make_bc, mass_block,
                            vector_stiffness_block)
from ..fem.space import Function, FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..ops.elemspmv import SumOperator
from ..solvers.stokes import stokes_schur_cg

__all__ = ["stokes_solve", "stokes_solve_mg", "stokes_zero_fields",
           "taylor_hood_spaces"]


def taylor_hood_spaces(mesh: MeshData) -> Tuple[FunctionSpace, FunctionSpace]:
    V = FunctionSpace(mesh, "P2", vs=2)
    Q = FunctionSpace(mesh, "P1", vs=1)
    return V, Q


def stokes_zero_fields(mesh: MeshData):
    """Zero velocity/pressure for no-adv mode (ref solvers.py:308-315)."""
    V, Q = taylor_hood_spaces(mesh)
    return V.new_function(), Q.new_function()


_SADDLE_CACHE = {}


def _pad_rect_args(B, ns_pad, np_pad, NB_pad, iperm_v=None):
    """Shape-bucketed divergence-block arrays with their scatter plans.

    Padding entities carry zero matrices and scatter into the last
    (constrained) padded dof -- a no-op.  All index spaces are the
    PADDED ones, so the compiled saddle program is shared by every mesh
    in the same bucket.  iperm_v: velocity-space old->new scalar-dof
    map when the velocity system is RCM-renumbered (banded operator);
    columns address the interleaved (2*dof+comp) layout.
    """
    Be = np.asarray(B.B_e)
    rd = np.asarray(B.row_dofs)
    cd = np.asarray(B.col_dofs)
    NB, nr, ncol = Be.shape
    if NB_pad > NB:
        Be = np.concatenate(
            [Be, np.zeros((NB_pad - NB, nr, ncol), Be.dtype)])
        rd = np.concatenate(
            [rd, np.full((NB_pad - NB, nr), np_pad - 1, rd.dtype)])
        cd = np.concatenate(
            [cd, np.full((NB_pad - NB, ncol), 2 * ns_pad - 1, cd.dtype)])
    if iperm_v is not None:
        cd = iperm_v[cd // 2] * 2 + cd % 2
    r_ids = rd.ravel()
    r_perm = np.argsort(r_ids, kind="stable")
    c_ids = cd.ravel()
    c_perm = np.argsort(c_ids, kind="stable")
    import jax.numpy as jnp
    return (jnp.asarray(Be), jnp.asarray(rd, dtype=jnp.int32),
            jnp.asarray(cd, dtype=jnp.int32),
            jnp.asarray(r_perm, dtype=jnp.int32),
            jnp.asarray(r_ids[r_perm], dtype=jnp.int32),
            jnp.asarray(c_perm, dtype=jnp.int32),
            jnp.asarray(c_ids[c_perm], dtype=jnp.int32))


_SADDLE_M_CACHE = {}


def _saddle_M_program(Mfn, with_Z):
    """Block-diagonal saddle preconditioner fn, cached on the velocity
    V-cycle program so it (and the MINRES chunk compiled against it) is
    reused across geometries: (Margs, mp[, Z, Cinv]) all arrive as
    arguments.  Applies diag(MG(A), mp + Z Cinv Z^T) to (U, p)."""
    key = (id(Mfn), bool(with_Z))
    hit = _SADDLE_M_CACHE.get(key)
    if hit is not None and hit[1] is Mfn:
        return hit[0]

    if with_Z:
        def M(args, x):
            margs, mp, Z, Cinv = args
            U, p = x
            dt = p.dtype
            hi = jax.lax.Precision.HIGHEST
            corr = jnp.matmul(
                Z.astype(dt), jnp.matmul(
                    Cinv.astype(dt), jnp.matmul(Z.astype(dt).T, p,
                                                precision=hi),
                    precision=hi), precision=hi)
            return (Mfn(margs, U), mp.astype(dt) * p + corr)
    else:
        def M(args, x):
            margs, mp = args
            U, p = x
            return (Mfn(margs, U), mp.astype(p.dtype) * p)

    _SADDLE_M_CACHE[key] = (M, Mfn)
    return M


def _saddle_program(key):
    """Stable saddle-operator program: [[A, B^T],[B, 0]] on
    (U (ns_pad, 2) scalar-layout velocity, p (np_pad,)) pytrees.

    All arrays arrive as arguments (parallel/sweep.py convention); key
    carries only bucketed shapes: (velocity struct key, np_pad) -- every
    mesh in the same buckets reuses the compiled program.
    """
    hit = _SADDLE_CACHE.get(key)
    if hit is not None:
        return hit
    import jax
    import jax.numpy as jnp
    from ..parallel.sweep import _operator_program
    vkey, np_pad = key
    ns_pad = vkey[0]
    A_fn, _, _, _ = _operator_program(vkey)

    def S_fn(args, x):
        a, (B_e, rdofs, cdofs, rperm, rids, cperm, cids), free_p = args
        U, p = x
        free = a[3]
        Um = jnp.where(free[:, None], U, 0.0)
        pm = jnp.where(free_p, p, 0.0)
        # velocity block: A U (identity on constrained rows) + B^T p
        AU = A_fn(a, U)
        u_flat = Um.reshape(-1)                     # (2*ns_pad,)
        pe = pm[rdofs]
        ye_t = jnp.einsum("nij,ni->nj", B_e, pe,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=p.dtype)
        Btp_flat = jax.ops.segment_sum(
            ye_t.reshape(-1)[cperm], cids,
            num_segments=2 * ns_pad, indices_are_sorted=True)
        Btp = Btp_flat.reshape(ns_pad, 2)
        opU = AU + jnp.where(free[:, None], Btp, 0.0)
        # pressure block: B U, identity on pinned + padding rows
        xe = u_flat[cdofs]
        ye = jnp.einsum("nij,nj->ni", B_e, xe,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=U.dtype)
        Bu = jax.ops.segment_sum(
            ye.reshape(-1)[rperm], rids,
            num_segments=np_pad, indices_are_sorted=True)
        Bu = jnp.where(free_p, Bu, p)
        return (opU, Bu)

    _SADDLE_CACHE[key] = S_fn
    return S_fn


class StokesSetup(NamedTuple):
    """Everything stokes_solve_mg needs past assembly: the saddle
    program + its argument pytrees, block preconditioners, RHS, and the
    bookkeeping to map the solution back to FunctionSpace numbering.
    Split out so diagnostics (scripts/diag_stokes_spectrum.py) and
    cross-geometry batching can reuse the setup."""
    S_fn: object
    s64: object
    s32: object
    M64: object
    M32: object
    b: object
    G: object
    free_p: object
    sysV: object
    V: object
    Q: object
    ns_pad: int
    ns_true: int
    np_pad: int
    np_true: int
    iperm_v: object
    ml: object


_KZ_PAD = 48   # fixed coarse-space width so compiled programs are
               # shared across geometries (unused columns are zero);
               # sized for channel AR 10 (k<~15) + cavity AR up to 20
               # (k<~27, the very_deep_extreme / micro_width_deep
               # geometries) within one padded shape


def _coarse_pressure_basis(Q, H, np_true, np_pad, free_p_np, mp_lump):
    """Coarse pressure space for the Schur-side deflation.

    Dense spectral analysis (scripts/diag_stokes_spectrum.py) shows the
    block preconditioner diag(MG(A), Mp^-1) leaves a tail of small
    NEGATIVE eigenvalues that is (a) pure-pressure, (b) low-frequency
    along the channel axis, (c) h-independent, and (d) scales as 1/W^2
    with the channel width -- the classical inf-sup degradation of an
    elongated domain (lambda_min = 2.0e-3 at W/H=10: ~420-600 MINRES
    iterations).  Those modes are spanned by cosines in x plus the
    sulcus-cavity indicator (the cavity communicates with the channel
    only through the narrow mouth, giving one near-uniform cavity
    mode).  Returns an Mp-orthonormal (np_pad, _KZ_PAD) basis, zero
    columns beyond the kept rank.
    """
    pc = np.asarray(Q.dof_coords)[:np_true]
    x, y = pc[:, 0], pc[:, 1]
    W = max(float(np.ptp(x)), 1e-30)
    xn = (x - x.min()) / W
    AR = W / max(H, 1e-30)
    # modes with Schur eigenvalue below the spectral bulk (~0.1) are
    # roughly k <~ 0.7*AR; take margin, cap at the padded width
    K = int(np.clip(np.ceil(1.2 * AR) + 3, 6, 20))
    cols = [np.cos(k * np.pi * xn) for k in range(K)]
    sul = y < -1e-12
    if sul.any():
        # the cavity is its own (possibly very elongated, depth >>
        # mouth) channel in -y: give it an adaptive cosine ladder in
        # depth plus linear-in-x enrichment (narrow mouths make the
        # cavity pressure nearly decoupled -- its low modes are as bad
        # as the channel's)
        ind = sul.astype(float)
        depth = max(float(-y.min()), 1e-30)
        xs = x[sul]
        wid = max(float(np.ptp(xs)) if xs.size else 0.0, 1e-30)
        xc = float(xs.mean()) if xs.size else 0.0
        yn = np.clip(-y / depth, 0.0, 1.0)
        xh = (x - xc) / wid
        K_cav = int(np.clip(np.ceil(1.2 * depth / wid) + 3, 3,
                            _KZ_PAD - K - 7))
        for k in range(K_cav):
            cols.append(ind * np.cos(k * np.pi * yn))
        for k in range(min(3, K_cav)):
            cols.append(ind * xh * np.cos(k * np.pi * yn))
    # inlet/outlet corner bumps: the pressure modes of the Poiseuille-
    # inflow / no-slip corner singularities sit at the bulk's lower edge
    # (lambda ~ 0.086, h-independent -- diag_stokes_spectrum.py); four
    # localised gaussians lift them
    sig = 0.15 * H
    for cx in (x.min(), x.max()):
        for cy in (0.0, H):
            r2 = (x - cx) ** 2 + (y - cy) ** 2
            cols.append(np.exp(-r2 / (2.0 * sig * sig)))
    Z0 = np.stack(cols, axis=1)
    Z0[~free_p_np[:np_true]] = 0.0
    w = np.sqrt(np.clip(mp_lump, 1e-300, None))
    Qm, Rm = np.linalg.qr(Z0 * w[:, None])
    d = np.abs(np.diag(Rm))
    keep = d > 1e-10 * d.max()
    Zq = Qm[:, keep] / w[:, None]
    Z = np.zeros((np_pad, _KZ_PAD))
    Z[:np_true, : Zq.shape[1]] = Zq
    return Z


def _stokes_mg_setup(mesh: MeshData, H: float,
                     level_factors=(3.0, 9.0),
                     pin_outlet_pressure=False,
                     pad_shapes=None) -> StokesSetup:
    import jax
    import jax.numpy as jnp
    from ..parallel.sweep import (_bucket, build_transport_system,
                                  operator_args, sys_struct_key)
    from ..solvers.multilevel import (build_multilevel, level_meshes_for,
                                      make_ml_preconditioner)
    import os as _os
    import time as _time
    _timing = _os.environ.get("FEU_TIMING", "0") == "1"
    _t0 = _time.perf_counter()

    def _t(label):
        nonlocal _t0
        if _timing:
            now = _time.perf_counter()
            print(f"  [stokes setup] {label}: {now - _t0:.2f}s",
                  flush=True)
            _t0 = now

    dirichlet = [(MARKERS["left"], 0.0), (MARKERS["top"], 0.0),
                 (MARKERS["bottom"], 0.0)]
    # the banded (RCM-renumbered) velocity operator is the f32 MINRES
    # workhorse; the G lift, divergence columns, and output extraction
    # are mapped through sysV.iperm into the renumbered space
    sysV = build_transport_system(mesh, element="P2", with_robin=False,
                                  dirichlet=dirichlet,
                                  pad_shapes=pad_shapes)
    _t("velocity system")
    ns_pad, ns_true = sysV.ndofs, sysV.space.ndofs
    iperm_v = None if sysV.iperm is None else np.asarray(sysV.iperm)
    V, Q = taylor_hood_spaces(mesh)
    # assemble the coupling/mass blocks at bucket shapes too (same
    # rationale as build_transport_system: raw mesh sizes would compile
    # the einsums once per geometry)
    pad_tv = pad_q = None
    if ns_pad != ns_true:
        T_pad = _bucket(len(mesh.cells), 4096)
        V_pad = _bucket(len(mesh.vertices) + 3, 4096)
        pad_tv = (T_pad, V_pad)
        pad_q = (T_pad, Q.ndofs + 1, Q.ndofs, V_pad)
    B = divergence_block(Q, V, pad=pad_tv)
    Mp = mass_block(Q, pad=pad_q)
    _t("coupling/mass blocks")
    np_true = Q.ndofs
    np_pad = _bucket(np_true, 2048) if ns_pad != ns_true else np_true

    # Poiseuille inflow lift on the scalar x-component
    space = sysV.space
    Gn = np.zeros((ns_pad, 2))
    left = space.boundary_scalar_dofs(mesh.bc_marker == MARKERS["left"])
    yv = space.dof_coords[left][:, 1]
    left_rows = left if iperm_v is None else iperm_v[left]
    Gn[left_rows, 0] = 4.0 * yv * (H - yv)
    G = jnp.asarray(Gn)

    # lumped pressure mass inverse (padding tail: identity); lumped on
    # the HOST (an eager device apply at the raw pressure size would be
    # a per-geometry compile)
    _Ae = np.asarray(Mp.A_e)
    _cd = np.asarray(Mp.entity_dofs)
    mp_lump = np.zeros(np_true + 1)
    np.add.at(mp_lump, _cd.ravel(), _Ae.sum(axis=2).ravel())
    mp_lump = mp_lump[:np_true]
    mp_inv = np.ones(np_pad)
    import os as _os
    _mp_scale = float(_os.environ.get("FEU_STOKES_MP_SCALE", "1.0"))
    mp_inv[:np_true] = _mp_scale / np.clip(mp_lump, 1e-300, None)
    mp64 = jnp.asarray(mp_inv)
    mp32 = mp64.astype(jnp.float32)

    # multigrid hierarchy on the velocity Laplacian (B=2 components)
    mids = level_meshes_for(mesh, level_factors)
    _t("level meshes")
    D2 = np.ones(2)
    ml = build_multilevel(sysV, mids, D2, mu_values=np.zeros(2),
                          dirichlet=dirichlet, with_robin=False)

    vkey = sys_struct_key(sysV)
    S_fn = _saddle_program((vkey, np_pad))
    D2j = jnp.asarray(D2)
    mu2j = jnp.zeros(2)
    NB_pad = _bucket(B.B_e.shape[0], 4096) if ns_pad != ns_true \
        else B.B_e.shape[0]
    Bargs64 = _pad_rect_args(B, ns_pad, np_pad, NB_pad, iperm_v=iperm_v)
    Bargs32 = (Bargs64[0].astype(jnp.float32),) + Bargs64[1:]
    a64 = operator_args(sysV, D2j, mu2j, None, f32=False)
    a32 = operator_args(sysV, D2j, mu2j, None, f32=True)
    # pressure free mask: padding rows are identity; the optional
    # explicit pin at the outlet-bottom corner implements the
    # reference's OutletPoint (solvers.py:272-283); default OFF -- the
    # do-nothing outflow already fixes the level, and
    # test_stokes_pressure_pin_inconsequential quantifies the difference
    free_p_np = np.ones(np_pad, dtype=bool)
    free_p_np[np_true:] = False
    if pin_outlet_pressure:
        pc = Q.dof_coords
        corner = np.array([pc[:, 0].max(), 0.0])
        pin = int(np.argmin(((pc - corner) ** 2).sum(1)))
        free_p_np[pin] = False
    free_p = jnp.asarray(free_p_np)
    s64 = (a64, Bargs64, free_p)
    s32 = (a32, Bargs32, free_p)

    _t("multilevel build")
    Mv64 = make_ml_preconditioner(ml, f32=False)
    Mv32 = make_ml_preconditioner(ml, f32=True)

    # RHS for the lifted system U = G + U0 (U0 zero on Dirichlet rows)
    free = sysV.free
    from ..parallel.sweep import _operator_program
    A_fn, rhs_fn, _, _ = _operator_program(vkey)
    rU = jnp.where(free[:, None], rhs_fn(a64, G), 0.0)
    (Be_p, rd_p, cd_p, rperm_p, rids_p, cperm_p, cids_p) = Bargs64
    pe = G.reshape(-1)[cd_p]
    ye = jnp.einsum("nij,nj->ni", Be_p, pe,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=G.dtype)
    rp = -jax.ops.segment_sum(
        ye.reshape(-1)[rperm_p], rids_p,
        num_segments=np_pad, indices_are_sorted=True)
    rp = jnp.where(free_p, rp, 0.0)   # pinned/padding dofs: p = 0
    b = (rU, rp)
    _t("lift/rhs")

    # ---- coarse Schur correction (deflation of the elongated-channel
    # inf-sup tail; see _coarse_pressure_basis) -------------------------
    # Galerkin-project the MG-approximated Schur complement
    # S~ = B MG(A) B^T onto the coarse space Z, and add
    # Z (Z^T S~ Z)^-1 Z^T to the pressure preconditioner.  The corrected
    # modes move from O(1/AR^2) to O(1); measured: the negative interval
    # condition drops ~323 -> ~15 at W/H=10 (diag_stokes_spectrum.py).
    Z64 = Cinv64 = None
    if _os.environ.get("FEU_STOKES_COARSE_P", "1") == "1":
        Z_np = _coarse_pressure_basis(Q, H, np_true, np_pad,
                                      free_p_np, mp_lump)
        Z64 = jnp.asarray(Z_np)

        # velocity image of each mode: V_k = mask_free(B^T z_k), through
        # the same padded arrays the saddle operator uses
        pz = Z64[rd_p]                         # (NB, nr, KZ)
        yz = jnp.einsum("nij,niz->njz", Be_p, pz,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=Z64.dtype)
        KZ = Z64.shape[1]
        flat = yz.reshape(-1, KZ)[cperm_p]
        VTf = jax.ops.segment_sum(flat, cids_p,
                                  num_segments=2 * ns_pad,
                                  indices_are_sorted=True)
        VT = VTf.reshape(ns_pad, 2, KZ)
        VT = jnp.where(free[:, None, None], VT, 0.0)

        # ALL mode images through the f32 cycle in ONE wide apply: the
        # V-cycle program is structure-keyed with the column count as a
        # traced dimension, so a (n, 2*KZ) call compiles once per level
        # shape class (shared by every geometry of a study) and replaces
        # the KZ=48 sequential (n, 2) dispatches that dominated the
        # warm deflation build (4.8 s -> one dispatch).  D/mu vectors
        # broadcast to the wide width (all columns are unit-D Laplacian
        # components).  f32 mode images are ample for a PRECONDITIONER
        # basis: S_Z entries carry ~1e-7 relative noise against an
        # approximation already ~O(1) from MG(A)~A.
        Mfn32, Margs32 = Mv32
        VT32 = VT.astype(jnp.float32)
        lv_a, fc_a, Ai_a, Dv_a, mu_a, om_a = Margs32
        # degenerate batch dims broadcast inside the traced program
        # (dinv (n,1) against (n,2KZ); Ainv (1,nc,nc) in the batched
        # coarse matmul), so no (2KZ, nc, nc) inverse copies
        # materialise; D/mu ride as full-width coef vectors.
        lv_w = tuple(la._replace(dinv=la.dinv[:, :1]) for la in lv_a)
        wide_args = (lv_w, fc_a, Ai_a[:1],
                     jnp.ones(2 * KZ, Dv_a.dtype),
                     jnp.zeros(2 * KZ, mu_a.dtype), om_a)
        Xwide = VT32.transpose(0, 2, 1).reshape(VT32.shape[0], 2 * KZ)
        # jitted: an eager cycle compiles every primitive on its own
        Wwide = jax.jit(Mfn32)(wide_args, Xwide)
        Wm = Wwide.reshape(VT32.shape[0], KZ, 2).transpose(0, 2, 1)
        S_Z = np.asarray(jnp.einsum(
            "nik,niz->kz", VT, Wm.astype(jnp.float64),
            precision=jax.lax.Precision.HIGHEST))
        S_Z = 0.5 * (S_Z + S_Z.T)
        # zero (padding / rank-dropped) columns: identity diagonal so
        # the inverse exists; their Z columns are zero so they
        # contribute nothing to the correction
        zero_cols = ~np.any(np.abs(Z_np) > 0.0, axis=0)
        S_Z[zero_cols, :] = 0.0
        S_Z[:, zero_cols] = 0.0
        S_Z[zero_cols, zero_cols] = 1.0
        ws, Vs = np.linalg.eigh(S_Z)
        ws = np.clip(ws, 1e-10 * max(ws.max(), 1e-30), None)
        # 0.3 places corrected modes just above the spectral bulk's
        # centre instead of overshooting past 1 (measured: 132 vs 160
        # MINRES iters at scale 0.3 vs 1.0, h=0.06 base geometry)
        scale = float(_os.environ.get("FEU_STOKES_COARSE_SCALE", "0.3"))
        Cinv_np = scale * (Vs / ws) @ Vs.T
        Cinv64 = jnp.asarray(Cinv_np)
        _t("coarse Schur deflation")

    def make_M(Mv, mp, Z, Cinv):
        # every array travels in m_args, NOT the closure: closure
        # constants get baked into the MINRES chunk's HLO, which (a)
        # recompiles per geometry and (b) at h<=0.02 makes the program
        # very large once the deflation basis Z joins.  The fn itself is cached on the
        # velocity-cycle program so minres_tree's id-keyed chunk cache
        # is shared by every mesh in the same shape bucket.
        Mfn, Margs = Mv
        M = _saddle_M_program(Mfn, with_Z=Z is not None)
        args = (Margs, mp) if Z is None else (Margs, mp, Z, Cinv)
        return (M, args)

    M64 = make_M(Mv64, mp64, Z64, Cinv64)
    M32 = make_M(Mv32, mp32,
                 None if Z64 is None else Z64.astype(jnp.float32),
                 None if Cinv64 is None else Cinv64.astype(jnp.float32))

    return StokesSetup(S_fn=S_fn, s64=s64, s32=s32, M64=M64, M32=M32,
                       b=b, G=G, free_p=free_p, sysV=sysV, V=V, Q=Q,
                       ns_pad=ns_pad, ns_true=ns_true, np_pad=np_pad,
                       np_true=np_true, iperm_v=iperm_v, ml=ml)


def stokes_solve_mg(mesh: MeshData, H: float, rtol=1e-11, maxiter=3000,
                    chunk_iters=None, precision=None,
                    level_factors=(3.0, 9.0),
                    pin_outlet_pressure=False, pad_shapes=None):
    """Stokes via block-preconditioned MINRES (the production path).

    The saddle system is solved whole with MINRES + diag(MG(A), lumped
    pressure mass) -- mesh-independent iteration counts (Silvester &
    Wathen), versus the Uzawa/Schur path's 10-40k nested inner
    iterations.  The velocity Laplacian A = kron(K_scalar, I_2) runs
    through the scalar batch-minor element kernels with the two
    components as a B=2 sweep batch.  precision="mixed" runs the bulk in
    f32 MINRES passes wrapped in f64 defect correction (saddle-level
    mixed precision); the default is f64, which measured faster on the
    H100 in the adv-diff study (PERF.md).

    Replaces ref solvers.py:237-306 (Taylor-Hood + direct LU).
    """
    import os as _os
    import jax
    import jax.numpy as jnp
    from ..solvers.minres import minres_tree

    if precision is None:
        precision = "f64"
    if chunk_iters is None:
        # each defect pass converges in 48-80 MINRES iterations at study
        # scale; the chunk's masked updates mean a dispatched iteration
        # costs full compute whether active or not, so 80 (vs the old
        # 120) cuts ~1/3 of the solve FLOPs without adding round trips
        chunk_iters = int(_os.environ.get("FEU_STOKES_CHUNK", "80"))

    st = _stokes_mg_setup(mesh, H, level_factors=level_factors,
                          pin_outlet_pressure=pin_outlet_pressure,
                          pad_shapes=pad_shapes)
    S_fn, s64, s32 = st.S_fn, st.s64, st.s32
    M64, M32, b, G = st.M64, st.M32, st.b, st.G
    ns_true, np_true = st.ns_true, st.np_true
    iperm_v = st.iperm_v
    V, Q = st.V, st.Q
    rU, rp = b

    if precision == "f64":
        res = minres_tree((S_fn, s64), b, M=M64, rtol=rtol,
                          maxiter=maxiter, chunk_iters=chunk_iters)
        x = res.x
        total_iters = res.iters
        rn = res.true_resnorm
        converged = bool(res.converged)  # MINRES's M-norm criterion
    else:
        # saddle-level mixed precision: f32 MINRES + f64 defect passes
        import operator as _op
        bnorm = float(jnp.sqrt(
            jnp.sum(b[0] * b[0]) + jnp.sum(b[1] * b[1])))
        x = (jnp.zeros_like(rU), jnp.zeros_like(rp))
        total_iters = 0
        rn = bnorm
        _timing = _os.environ.get("FEU_TIMING", "0") == "1"
        import time as _time
        _tp = _time.perf_counter()
        for _pass in range(8):
            SU, Sp = S_fn(s64, x)
            r = (b[0] - SU, b[1] - Sp)
            rn = float(jnp.sqrt(
                jnp.sum(r[0] * r[0]) + jnp.sum(r[1] * r[1])))
            if rn <= rtol * max(bnorm, 1e-300):
                break
            r32 = (r[0].astype(jnp.float32), r[1].astype(jnp.float32))
            # per-pass depth: restarts discard Krylov history, but f32
            # MINRES stagnates below ~1e-5 relative on this saddle
            # (measured: rtol 2e-6 -> 720 total iters vs 600 at 2e-5)
            _pass_rtol = float(_os.environ.get("FEU_STOKES_PASS_RTOL",
                                               "2e-5"))
            res = minres_tree((S_fn, s32), r32, M=M32, rtol=_pass_rtol,
                              maxiter=maxiter, chunk_iters=chunk_iters)
            total_iters += res.iters
            x = (x[0] + res.x[0].astype(jnp.float64),
                 x[1] + res.x[1].astype(jnp.float64))
            if _timing:
                _now = _time.perf_counter()
                print(f"  [stokes solve] pass {_pass}: {res.iters} iters "
                      f"in {_now - _tp:.2f}s (rn={rn:.2e})", flush=True)
                _tp = _now
        else:
            # loop exhausted: rn above is one pass stale; refresh it
            SU, Sp = S_fn(s64, x)
            rn = float(jnp.sqrt(jnp.sum((b[0] - SU) ** 2)
                                + jnp.sum((b[1] - Sp) ** 2)))
        converged = bool(rn <= rtol * max(bnorm, 1e-300))

    U0, p_pad = x
    U = np.asarray(G + U0)
    if iperm_v is not None:
        # back to the FunctionSpace's scalar-dof numbering (host: a
        # device gather at the raw size is a per-geometry compile)
        U = U[iperm_v[:ns_true]]
    u_interleaved = np.asarray(U[:ns_true]).reshape(-1)
    p_out = np.asarray(p_pad[:np_true])
    u = Function(V, jnp.asarray(u_interleaved))
    p = Function(Q, jnp.asarray(p_out))
    info = {"outer_iters": int(total_iters), "inner_iters": 0,
            "resnorm": float(rn), "converged": converged,
            "method": "minres+mg"}
    u.solver_info = info
    p.solver_info = info
    return u, p


def stokes_solve(mesh: MeshData, H: float,
                 inner_rtol=5e-13, outer_rtol=1e-9,
                 outer_maxiter=400, precision=None):
    """Solve Stokes flow; returns (u Function on V, p Function on Q).

    Default path: block-preconditioned MINRES + velocity multigrid
    (stokes_solve_mg; equivalence-tested against the Schur-CG path at
    1e-10).  FEU_STOKES=schur selects the round-1 Uzawa/Schur solver.

    outer_rtol=1e-9: each f64 defect pass gains ~4.5 orders, so the
    solve stops after 2 MINRES passes (~125 iters) with a true relative
    residual ~4e-10 -- five-plus orders below the 1e-3..1e-4
    mesh-realisation floors every golden comparison sits on.  The old
    1e-11 default bought a third full pass for accuracy no downstream
    consumer can observe.

    The solved fields are disk-checkpointed per (mesh, H, rtol,
    method) -- the flow field is a pure function of the geometry, so study re-runs,
    replot passes, and downstream transport sweeps reload it in
    milliseconds (FEU_DISK_CACHE=0 disables, as for all caches).
    """
    import os
    method = os.environ.get("FEU_STOKES", "mg")

    from ..utils.diskcache import cache_key_of, load_arrays, store_arrays
    # schur-path accuracy is controlled by inner_rtol/outer_maxiter too;
    # keep them out of the mg key so the default path stays stable
    extra = (float(inner_rtol), int(outer_maxiter)) \
        if method == "schur" else ()
    key = cache_key_of("stokes-v1", np.asarray(mesh.vertices),
                       np.asarray(mesh.cells), float(H),
                       float(outer_rtol), precision, method, *extra)
    hit = load_arrays("stokes", key)
    if hit is not None:
        import jax.numpy as jnp
        V, Q = taylor_hood_spaces(mesh)
        u = Function(V, jnp.asarray(hit["u"]))
        p = Function(Q, jnp.asarray(hit["p"]))
        info = {"outer_iters": int(hit["outer_iters"]),
                "inner_iters": int(hit["inner_iters"]),
                "resnorm": float(hit["resnorm"]),
                "converged": bool(hit.get("converged", True)),
                "method": str(hit["method"]) + "+cache"}
        u.solver_info = info
        p.solver_info = info
        return u, p

    if method == "mg":
        u, p = stokes_solve_mg(mesh, H, rtol=outer_rtol,
                               precision=precision)
    else:
        u, p = stokes_solve_schur(mesh, H, inner_rtol=inner_rtol,
                                  outer_rtol=outer_rtol,
                                  outer_maxiter=outer_maxiter,
                                  precision=precision)
    info = u.solver_info
    # never persist a non-converged field: a cached miss is recomputed,
    # a cached lie is replayed forever
    if info.get("converged", False):
        store_arrays("stokes", key, {
            "u": np.asarray(u.values), "p": np.asarray(p.values),
            "outer_iters": int(info.get("outer_iters", 0)),
            "inner_iters": int(info.get("inner_iters", 0)),
            "resnorm": float(info.get("resnorm", 0.0)),
            "converged": bool(info.get("converged", False)),
            "method": info.get("method", method)})
    return u, p


def stokes_solve_schur(mesh: MeshData, H: float,
                       inner_rtol=5e-13, outer_rtol=1e-11,
                       outer_maxiter=400, precision=None):
    """Round-1 pressure-Schur (Uzawa) CG path (solvers/stokes.py)."""
    import jax

    if precision is None:
        precision = "f64"
    V, Q = taylor_hood_spaces(mesh)
    Ablk = vector_stiffness_block(V)
    A = SumOperator([Ablk], V.ndofs)
    B = divergence_block(Q, V)
    Mp = mass_block(Q)

    # column-wise operator applies for the chunked solver ((n,1) layout)
    import jax.numpy as jnp
    A64_e = Ablk.A_e
    A32_e = Ablk.A_e.astype(jnp.float32)
    dofs = Ablk.entity_dofs
    perm = Ablk.scatter.perm
    ids_sorted = Ablk.scatter.ids_sorted
    ndofs = V.ndofs

    def _apply_cols(Ae, X):
        Xe = X[dofs]                                   # (N, nd, B)
        Ye = jnp.einsum("nij,njb->nib", Ae, Xe,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=X.dtype)
        N, nd, Bc = Ye.shape
        return jax.ops.segment_sum(Ye.reshape(N * nd, Bc)[perm],
                                   ids_sorted, num_segments=ndofs,
                                   indices_are_sorted=True)

    A_apply_col = lambda X: _apply_cols(A64_e, X)
    A_apply32_col = lambda X: _apply_cols(A32_e, X)

    def inflow(x, y):
        # Poiseuille profile (ref solvers.py:254-258)
        return np.stack([4.0 * y * (H - y), np.zeros_like(y)], axis=1)

    bc = make_bc(V, [
        (MARKERS["left"], inflow),
        (MARKERS["bottom"], 0.0),
        (MARKERS["top"], 0.0),
    ])

    # lumped pressure mass inverse as Schur preconditioner
    ones = jnp.ones(Q.ndofs)
    from ..ops.elemspmv import SumOperator as _S
    Mp_op = _S([Mp], Q.ndofs)
    mp_lump = Mp_op.apply(ones)
    mp_inv = 1.0 / jnp.where(mp_lump > 0, mp_lump, 1.0)

    res = stokes_schur_cg(
        A_apply_col, B, bc,
        Mp_inv=lambda r: mp_inv * r,
        A_diag=A.diagonal(),
        A_apply32=A_apply32_col,
        inner_rtol=inner_rtol, outer_rtol=outer_rtol,
        outer_maxiter=outer_maxiter, precision=precision)

    u = Function(V, res.u)
    p = Function(Q, res.p)
    info = {
        "outer_iters": int(res.outer_iters),
        "inner_iters": int(res.inner_iters),
        "resnorm": float(res.resnorm),
        "converged": bool(res.converged),
    }
    u.solver_info = info
    p.solver_info = info
    return u, p
