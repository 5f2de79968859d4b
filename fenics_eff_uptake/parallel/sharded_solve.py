"""Production sharded sweep solve: DP over "sweep" x TP over "cells".

Round-1's ShardedMuSweep (parallel/sharding.py) proved the sharding
pattern but used an unpreconditioned, unchunked Jacobi-CG -- demo-grade.
This module runs the REAL solver stack -- batch-minor chunked CG with the
multigrid V-cycle preconditioner and mixed f32/f64 refinement -- under a
jax.sharding.Mesh:

  "sweep" (DP): the (n, B) Krylov state is sharded on the B axis; every
      vector op and reduction is column-local -- zero collectives.
  "cells" (TP): each device owns an element-chunk of the operator with
      its own gather/scatter plan; an operator apply is
      local-scatter -> psum("cells") -- the one collective.

The preconditioner's coarse levels are tiny and replicated across the
"cells" groups (identical redundant compute beats communicating), while
its fine-level smoothing operator is cells-sharded like A.

Chunking, per-column freezing, and f64 refinement reuse the exact
host-loop protocol of solvers/batched.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # jax < 0.8
    from jax.experimental.shard_map import shard_map

__all__ = ["build_sharded_system", "sharded_solve_sweep",
           "ShardedSystem", "build_sharded_stokes",
           "sharded_stokes_solve", "ShardedStokes"]

# f32 products in the V-cycle and the Schur deflation run at full f32
# precision (a GPU would otherwise take TF32)
_HI = jax.lax.Precision.HIGHEST


class _ShardBlockArgs(NamedTuple):
    """Element block split into per-"cells"-shard chunks.

    Arrays carry a leading shard axis (tp, ...); each shard has its own
    scatter plan into the FULL dof vector (summed via psum).
    """
    A: jnp.ndarray            # (tp, N_loc, nd, nd)
    dofs: jnp.ndarray         # (tp, N_loc, nd)
    perm: jnp.ndarray         # (tp, N_loc*nd)
    ids_sorted: jnp.ndarray   # (tp, N_loc*nd)


def _split_block(block, tp: int, ndofs: int, dummy_dof: int):
    """Split a _Block's entities into tp chunks with local scatter plans."""
    A = np.asarray(block.A64)
    dofs = np.asarray(block.dofs)
    N, nd, _ = A.shape
    N_loc = (N + tp - 1) // tp
    N_pad = N_loc * tp
    if N_pad > N:
        A = np.concatenate(
            [A, np.zeros((N_pad - N, nd, nd), A.dtype)], axis=0)
        dofs = np.concatenate(
            [dofs, np.full((N_pad - N, nd), dummy_dof, dofs.dtype)],
            axis=0)
    As, Ds, Ps, Is = [], [], [], []
    for t in range(tp):
        sl = slice(t * N_loc, (t + 1) * N_loc)
        d = dofs[sl]
        ids = d.ravel()
        perm = np.argsort(ids, kind="stable")
        As.append(A[sl])
        Ds.append(d)
        Ps.append(perm)
        Is.append(ids[perm])
    return _ShardBlockArgs(
        A=jnp.asarray(np.stack(As)),
        dofs=jnp.asarray(np.stack(Ds), dtype=jnp.int32),
        perm=jnp.asarray(np.stack(Ps), dtype=jnp.int32),
        ids_sorted=jnp.asarray(np.stack(Is), dtype=jnp.int32))


def _local_apply(ba, ndofs, X, coef=None, A_batch=None):
    """One shard's entity chunk applied into the full dof vector.

    ba arrays arrive WITHOUT the shard axis (shard_map strips it).
    ``A_batch`` (1, N_loc, B, nd, nd) supplies per-sample entity
    matrices (step-mu Robin batches) instead of ``ba.A`` x ``coef``;
    its B axis is sharded over "sweep" like the Krylov state.
    """
    dofs = ba.dofs[0]
    perm = ba.perm[0]
    ids = ba.ids_sorted[0]
    Xe = X[dofs]                                   # (N_loc, nd, B)
    nd = Xe.shape[1]
    if A_batch is not None:
        Ac = A_batch[0].astype(X.dtype)            # (N_loc, B, nd, nd)
        Ye = jnp.stack(
            [sum(Ac[:, :, i, j] * Xe[:, j, :] for j in range(nd))
             for i in range(nd)], axis=1)          # (N_loc, nd, B)
    else:
        Ac = ba.A[0].astype(X.dtype)
        Ye = jnp.stack(
            [sum(Ac[:, i, j, None] * Xe[:, j, :] for j in range(nd))
             for i in range(nd)], axis=1)
        if coef is not None:
            Ye = Ye * coef.astype(X.dtype)[None, None, :]
    N, _, B = Ye.shape
    return jax.ops.segment_sum(
        Ye.reshape(N * nd, B)[perm], ids,
        num_segments=ndofs, indices_are_sorted=True)


class ShardedSystem(NamedTuple):
    sys: "object"                 # fine TransportSystem
    mesh_dev: Mesh
    K: _ShardBlockArgs
    Adv: Optional[_ShardBlockArgs]
    R: Optional[_ShardBlockArgs]
    ml: "object"                  # MultilevelData or None
    ml_K: Optional[_ShardBlockArgs]   # fine-level smoother operator
    # per-sample Robin entity matrices (step-mu(x) sweeps): cells-chunked
    # like R, with the sweep axis whole -> (tp, N_loc, B, nd, nd), plus
    # the unsplit (B, N, nd, nd) host view for the eager RHS/diag program
    Rb: Optional[jnp.ndarray] = None
    Rb_full: Optional[jnp.ndarray] = None


def _split_batch_matrices(R_batch, tp: int):
    """Chunk per-sample entity matrices (B, N, nd, nd) along the entity
    axis with the SAME padding/order as _split_block -> the chunks stay
    aligned with ``R``'s per-shard scatter plans."""
    Rb = np.asarray(R_batch)
    B, N, nd, _ = Rb.shape
    N_loc = (N + tp - 1) // tp
    N_pad = N_loc * tp
    if N_pad > N:
        Rb = np.concatenate(
            [Rb, np.zeros((B, N_pad - N, nd, nd), Rb.dtype)], axis=1)
    # (B, tp*N_loc, nd, nd) -> (tp, N_loc, B, nd, nd)
    Rb = Rb.reshape(B, tp, N_loc, nd, nd)
    return jnp.asarray(np.moveaxis(Rb, 0, 2).copy())


def build_sharded_system(sys, device_mesh: Mesh, multilevel=None,
                         robin_batch=None):
    """Partition a TransportSystem (and optional MG data) over the mesh.

    ``robin_batch`` (B, N_facets, nd, nd) supplies per-sample Robin
    entity matrices (the step-mu(x) surrogates, ref
    adv_diff_analysis.py:144-178); it replaces the scalar ``mu_vec x R``
    term exactly as ``solve_sweep(..., robin_matrices=...)`` does."""
    tp = device_mesh.shape["cells"]
    dummy = sys.ndofs - 1   # scatter target for padding (masked anyway
    # by the bucketing dummy dof when pad_shapes was on; otherwise the
    # padded entities carry zero matrices so any target is harmless)
    K = _split_block(sys.K, tp, sys.ndofs, dummy)
    Adv = (_split_block(sys.Adv, tp, sys.ndofs, dummy)
           if sys.Adv is not None else None)
    R = (_split_block(sys.R, tp, sys.ndofs, dummy)
         if sys.R is not None else None)
    Rb = None
    Rb_full = None
    if robin_batch is not None:
        if sys.R is None:
            raise ValueError("robin_batch requires sys.R (the unit-mu "
                             "Robin block) for its scatter plan")
        Rb = _split_batch_matrices(robin_batch, tp)
        Rb_full = jnp.asarray(np.asarray(robin_batch))
    return ShardedSystem(sys=sys, mesh_dev=device_mesh, K=K, Adv=Adv,
                         R=R, ml=multilevel,
                         ml_K=K if multilevel is not None else None,
                         Rb=Rb, Rb_full=Rb_full)


def _sharded_ops(ss: ShardedSystem, f32: bool):
    """Shared machinery of the sharded Krylov chunks: the cells-psum
    operator apply, the (optionally multigrid) preconditioner builder,
    and the shard_map partition specs.  Used by both the CG (SPD
    transport) and BiCGStab (nonsymmetric adv-diff) chunk programs."""
    sys = ss.sys
    ndofs = sys.ndofs
    free = sys.free
    dt = jnp.float32 if f32 else jnp.float64
    ml = ss.ml

    blk_spec = _ShardBlockArgs(A=P("cells"), dofs=P("cells"),
                               perm=P("cells"), ids_sorted=P("cells"))
    col = P(None, "sweep")     # (n, B) arrays
    vec = P("sweep")           # (B,) arrays

    def A_apply(Kb, Advb, Rb, Rbb, D_vec, mu_vec, X):
        Y = _local_apply(Kb, ndofs, X, coef=D_vec)
        if Advb is not None:
            Y = Y + _local_apply(Advb, ndofs, X)
        if Rb is not None:
            if Rbb is not None:    # per-sample step-mu Robin matrices
                Y = Y + _local_apply(Rb, ndofs, X, A_batch=Rbb)
            else:
                Y = Y + _local_apply(Rb, ndofs, X, coef=mu_vec)
        Y = jax.lax.psum(Y, "cells")
        return Y

    def A_bc(Kb, Advb, Rb, Rbb, D_vec, mu_vec, X):
        Y = A_apply(Kb, Advb, Rb, Rbb, D_vec, mu_vec,
                    jnp.where(free[:, None], X, 0.0))
        return jnp.where(free[:, None], Y, X)

    if ml is not None:
        from ..solvers.multilevel import (_ml_program, _ml_struct_key,
                                          ml_preconditioner_args)
        # mid/coarse levels replicated; fine level operator inside the
        # V-cycle reuses the cells-sharded apply
        # band=False: the fine level is cells-partitioned here; a
        # replicated banded operator would cost full-system HBM/device
        m_args_global = ml_preconditioner_args(ml, f32=f32, band=False)

        def M_apply(Kb, Advb, Rb, Rbb, m_args, R):
            levels, free_c, Ainv, D_vec, mu_vec, omega = m_args
            la = levels[0]
            Rw = R.astype(dt)
            # fine pre-smooth
            x = omega * la.dinv * Rw
            Ax = A_bc(Kb, Advb, Rb, Rbb, D_vec, mu_vec, x)
            res = Rw - Ax
            # restrict, then run the REPLICATED sub-cycle on mid levels
            n, _, B = (la.t_w[:, :, None] * res[:, None, :]).shape
            flat = (la.t_w[:, :, None] * res[:, None, :]).reshape(
                n * 3, B)[la.t_perm]
            rc = jax.ops.segment_sum(
                flat, la.t_ids, num_segments=levels[1].free.shape[0]
                if len(levels) > 1 else free_c.shape[0],
                indices_are_sorted=True)
            if len(levels) > 1:
                rc = jnp.where(levels[1].free[:, None], rc, 0.0)
                xc = _sub_vcycle(levels, 1, rc, free_c, Ainv,
                                 D_vec, mu_vec, omega)
            else:
                rc = jnp.where(free_c[:, None], rc, 0.0)
                xc_b = jnp.matmul(Ainv,
                                  jnp.moveaxis(rc, 1, 0)[..., None],
                                  precision=_HI,
                                  preferred_element_type=jnp.float32)
                xc = jnp.moveaxis(xc_b[..., 0], 0, 1)
            x = x + jnp.einsum("nk,nkb->nb", la.t_w, xc[la.t_cols],
                               precision=_HI,
                               preferred_element_type=xc.dtype)
            Ax = A_bc(Kb, Advb, Rb, Rbb, D_vec, mu_vec, x)
            x = x + omega * la.dinv * (Rw - Ax)
            return x.astype(R.dtype)

        def _sub_vcycle(levels, l, r, free_c, Ainv, D_vec, mu_vec, omega):
            from ..parallel.sweep import _args_block_apply
            la = levels[l]
            nd_l = la.free.shape[0]

            def A_l(X):
                Y = _args_block_apply(la.K, nd_l, X,
                                      coef=D_vec.astype(X.dtype))
                if la.Adv is not None:
                    Y = Y + _args_block_apply(la.Adv, nd_l, X)
                if la.R is not None:
                    if la.R_batch is not None:   # per-sample step-mu
                        Y = Y + _args_block_apply(la.R, nd_l, X,
                                                  A_batch=la.R_batch)
                    else:
                        Y = Y + _args_block_apply(
                            la.R, nd_l, X, coef=mu_vec.astype(X.dtype))
                return jnp.where(la.free[:, None], Y, X)

            x = omega * la.dinv * r
            res = r - A_l(jnp.where(la.free[:, None], x, 0.0))
            n = la.t_w.shape[0]
            B = r.shape[1]
            flat = (la.t_w[:, :, None] * res[:, None, :]).reshape(
                n * 3, B)[la.t_perm]
            n_next = (levels[l + 1].free.shape[0]
                      if l + 1 < len(levels) else free_c.shape[0])
            rc = jax.ops.segment_sum(flat, la.t_ids,
                                     num_segments=n_next,
                                     indices_are_sorted=True)
            if l + 1 < len(levels):
                rc = jnp.where(levels[l + 1].free[:, None], rc, 0.0)
                xc = _sub_vcycle(levels, l + 1, rc, free_c, Ainv,
                                 D_vec, mu_vec, omega)
            else:
                rc = jnp.where(free_c[:, None], rc, 0.0)
                xc_b = jnp.matmul(Ainv,
                                  jnp.moveaxis(rc, 1, 0)[..., None],
                                  precision=_HI,
                                  preferred_element_type=jnp.float32)
                xc = jnp.moveaxis(xc_b[..., 0], 0, 1)
            x = x + jnp.einsum("nk,nkb->nb", la.t_w, xc[la.t_cols],
                               precision=_HI,
                               preferred_element_type=xc.dtype)
            x = x + omega * la.dinv * (
                r - A_l(jnp.where(la.free[:, None], x, 0.0)))
            return x

        # spec for the ml args pytree: everything replicated except the
        # (B,)/( n,B)/(B,nc,nc) arrays which shard over "sweep"
        def _ml_spec(m_args):
            levels, free_c, Ainv, D_vec, mu_vec, omega = m_args
            def _blk_spec(b):
                return type(b)(P(), P(), P(), P(),
                               None if b.band is None else P())

            lev_specs = tuple(
                type(la)(K=_blk_spec(la.K),
                         Adv=None if la.Adv is None
                         else _blk_spec(la.Adv),
                         R=None if la.R is None
                         else _blk_spec(la.R),
                         R_batch=None if la.R_batch is None else P("sweep"),
                         free=P(), dinv=P(None, "sweep"),
                         t_cols=P(), t_w=P(), t_perm=P(), t_ids=P())
                for la in levels)
            return (lev_specs, P(), P("sweep"), P("sweep"), P("sweep"),
                    P())
        m_spec = _ml_spec(m_args_global)
    else:
        M_apply = None
        m_args_global = None
        m_spec = None

    def make_Mfn(Kb, Advb, Rb, Rbb, m_args, dinv):
        def Mfn(R):
            if ml is not None:
                return M_apply(Kb, Advb, Rb, Rbb, m_args, R)
            return dinv * R
        return Mfn

    return dict(A_bc=A_bc, make_Mfn=make_Mfn, blk_spec=blk_spec,
                col=col, vec=vec, m_spec=m_spec,
                m_args_global=m_args_global)


def _cg_chunk_sharded(ss: ShardedSystem, n_iters: int, f32: bool):
    """Jitted shard_map CG chunk over (sweep, cells)."""
    ops = _sharded_ops(ss, f32)
    A_bc, make_Mfn = ops["A_bc"], ops["make_Mfn"]
    blk_spec, col, vec, m_spec = (ops["blk_spec"], ops["col"],
                                  ops["vec"], ops["m_spec"])
    m_args_global = ops["m_args_global"]

    def chunk_impl(Kb, Advb, Rb, Rbb, D_vec, mu_vec, m_args, dinv,
                   X, Rr, Z, Pp, rz, tol):
        Mfn = make_Mfn(Kb, Advb, Rb, Rbb, m_args, dinv)

        def body(_, state):
            X, Rr, Z, Pp, rz = state
            active = jnp.sqrt(jnp.sum(Rr * Rr, axis=0)) > tol
            AP = A_bc(Kb, Advb, Rb, Rbb, D_vec, mu_vec, Pp)
            pAp = jnp.sum(Pp * AP, axis=0)
            alpha = jnp.where(active & (pAp != 0),
                              rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
            X = X + alpha[None, :] * Pp
            Rr = Rr - alpha[None, :] * AP
            Z = Mfn(Rr)
            rz_new = jnp.sum(Rr * Z, axis=0)
            beta = jnp.where(active & (rz != 0),
                             rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
            Pp = jnp.where(active[None, :], Z + beta[None, :] * Pp, Pp)
            return (X, Rr, Z, Pp, rz_new)

        X, Rr, Z, Pp, rz = jax.lax.fori_loop(
            0, n_iters, body, (X, Rr, Z, Pp, rz))
        return X, Rr, Z, Pp, rz, jnp.sqrt(jnp.sum(Rr * Rr, axis=0))

    in_specs = (blk_spec,
                None if ss.Adv is None else blk_spec,
                None if ss.R is None else blk_spec,
                None if ss.Rb is None else P("cells", None, "sweep"),
                vec, vec, m_spec, col,
                col, col, col, col, vec, vec)
    out_specs = (col, col, col, col, vec, vec)
    smap_kwargs = dict(mesh=ss.mesh_dev, in_specs=in_specs,
                       out_specs=out_specs)
    try:
        fn = shard_map(chunk_impl, check_vma=False, **smap_kwargs)
    except TypeError:
        fn = shard_map(chunk_impl, check_rep=False, **smap_kwargs)
    return jax.jit(fn), m_args_global


def _bicgstab_chunk_sharded(ss: ShardedSystem, n_iters: int, f32: bool):
    """Jitted shard_map BiCGStab chunk over (sweep, cells): the
    nonsymmetric (adv-diff) twin of _cg_chunk_sharded, mirroring the
    single-mesh batched recurrence (parallel/sweep.py
    _refine_program_bicgstab).  Collective budget: 2 operator psums +
    2 preconditioner applies (2 fine-level psums each under MG) per
    iteration, all over "cells"; the sweep axis stays
    collective-free."""
    ops = _sharded_ops(ss, f32)
    A_bc, make_Mfn = ops["A_bc"], ops["make_Mfn"]
    blk_spec, col, vec, m_spec = (ops["blk_spec"], ops["col"],
                                  ops["vec"], ops["m_spec"])
    m_args_global = ops["m_args_global"]

    def chunk_impl(Kb, Advb, Rb, Rbb, D_vec, mu_vec, m_args, dinv,
                   X, Rr, Rhat, Pp, V, rho, alpha, omega, tol):
        Mfn = make_Mfn(Kb, Advb, Rb, Rbb, m_args, dinv)

        def body(_, st):
            X, Rr, Pp, V, rho, alpha, omega = st
            active = jnp.sqrt(jnp.sum(Rr * Rr, axis=0)) > tol
            rho_new = jnp.sum(Rhat * Rr, axis=0)
            beta = jnp.where(
                active,
                (rho_new / jnp.where(rho != 0, rho, 1.0))
                * (alpha / jnp.where(omega != 0, omega, 1.0)), 0.0)
            Pp = jnp.where(
                active[None, :],
                Rr + beta[None, :] * (Pp - omega[None, :] * V), Pp)
            Phat = Mfn(Pp)
            V = A_bc(Kb, Advb, Rb, Rbb, D_vec, mu_vec, Phat)
            denom = jnp.sum(Rhat * V, axis=0)
            alpha = jnp.where(active & (denom != 0),
                              rho_new / jnp.where(denom != 0, denom,
                                                  1.0), 0.0)
            S = Rr - alpha[None, :] * V
            Shat = Mfn(S)
            T = A_bc(Kb, Advb, Rb, Rbb, D_vec, mu_vec, Shat)
            tt = jnp.sum(T * T, axis=0)
            omega = jnp.where(active & (tt != 0),
                              jnp.sum(T * S, axis=0)
                              / jnp.where(tt != 0, tt, 1.0), 0.0)
            X = X + alpha[None, :] * Phat + omega[None, :] * Shat
            Rr = jnp.where(active[None, :], S - omega[None, :] * T, Rr)
            return (X, Rr, Pp, V, rho_new, alpha, omega)

        X, Rr, Pp, V, rho, alpha, omega = jax.lax.fori_loop(
            0, n_iters, body, (X, Rr, Pp, V, rho, alpha, omega))
        return (X, Rr, Pp, V, rho, alpha, omega,
                jnp.sqrt(jnp.sum(Rr * Rr, axis=0)))

    in_specs = (blk_spec,
                None if ss.Adv is None else blk_spec,
                None if ss.R is None else blk_spec,
                None if ss.Rb is None else P("cells", None, "sweep"),
                vec, vec, m_spec, col,
                col, col, col, col, col, vec, vec, vec, vec)
    out_specs = (col, col, col, col, vec, vec, vec, vec)
    smap_kwargs = dict(mesh=ss.mesh_dev, in_specs=in_specs,
                       out_specs=out_specs)
    try:
        fn = shard_map(chunk_impl, check_vma=False, **smap_kwargs)
    except TypeError:
        fn = shard_map(chunk_impl, check_rep=False, **smap_kwargs)
    return jax.jit(fn), m_args_global


_SHARD_CHUNK_CACHE = {}


def sharded_solve_sweep(ss: ShardedSystem, D_values, mu_values,
                        rtol=1e-10, maxiter=5000, chunk_iters=50,
                        f32=False):
    """Chunked (optionally MG-preconditioned) CG over the device mesh.

    Same host protocol as solvers/batched.py: fixed-size device chunks,
    per-column freezing, only (B,) norms crossing the host boundary.
    Returns (X (B, ndofs) host layout, info).
    """
    sys = ss.sys
    dt = jnp.float32 if f32 else jnp.float64
    D_vec = jnp.asarray(np.asarray(D_values, dtype=np.float64)).astype(dt)
    mu_vec = jnp.asarray(np.asarray(mu_values,
                                    dtype=np.float64)).astype(dt)
    B = int(D_vec.shape[0])
    dp = ss.mesh_dev.shape["sweep"]
    if B % dp:
        raise ValueError(f"sweep batch {B} must divide over dp={dp}")

    nonsym = sys.Adv is not None
    key = (id(ss), chunk_iters, f32, nonsym, ss.Rb is not None)
    hit = _SHARD_CHUNK_CACHE.get(key)
    if hit is not None and hit[0] is ss:
        chunk, m_args = hit[1]
    else:
        maker = _bicgstab_chunk_sharded if nonsym else _cg_chunk_sharded
        chunk, m_args = maker(ss, chunk_iters, f32)
        _SHARD_CHUNK_CACHE[key] = (ss, (chunk, m_args))

    free = sys.free
    g = sys.bc_values.astype(dt)
    G = jnp.tile(g[:, None], (1, B))

    # eager RHS/diag via one chunk-free apply on device (replicated math)
    from ..parallel.sweep import _operator_program, operator_args, \
        sys_struct_key
    A_fn, rhs_fn, residual_fn, diag_fn = _operator_program(
        sys_struct_key(sys))
    a = operator_args(sys, D_vec.astype(jnp.float64),
                      mu_vec.astype(jnp.float64), ss.Rb_full, f32=f32)
    RHS = rhs_fn(a, G.astype(dt))
    dinv = diag_fn(operator_args(sys, D_vec.astype(jnp.float64),
                                 mu_vec.astype(jnp.float64), ss.Rb_full,
                                 f32=False)).astype(dt)

    X = G
    Rr = RHS - A_fn(a, X)
    bnorm = np.asarray(jnp.linalg.norm(RHS, axis=0))
    tol = jnp.asarray(rtol * bnorm, dtype=dt)

    iters = 0
    rn = np.asarray(jnp.linalg.norm(Rr, axis=0))
    tol_np = np.asarray(tol)
    col_iters = np.zeros(B, dtype=np.int64)
    if nonsym:
        Rhat = Rr
        Pp = jnp.zeros_like(Rr)
        V = jnp.zeros_like(Rr)
        ones = jnp.ones(B, dt)
        rho, alpha, omega = ones, ones, ones
        while iters < maxiter and (rn > tol_np).any():
            active = rn > tol_np
            (X, Rr, Pp, V, rho, alpha, omega, rn_dev) = chunk(
                ss.K, ss.Adv, ss.R, ss.Rb, D_vec, mu_vec, m_args, dinv,
                X, Rr, Rhat, Pp, V, rho, alpha, omega, tol)
            iters += chunk_iters
            rn = np.asarray(rn_dev)
            col_iters[active] = iters
    else:
        if ss.ml is not None:
            from ..solvers.multilevel import make_ml_preconditioner
            M_fn, M_args = make_ml_preconditioner(ss.ml, f32=f32)
            Z = M_fn(M_args, Rr)
        else:
            Z = dinv * Rr
        Pp = Z
        rz = jnp.sum(Rr * Z, axis=0)
        while iters < maxiter and (rn > tol_np).any():
            active = rn > tol_np
            X, Rr, Z, Pp, rz, rn_dev = chunk(
                ss.K, ss.Adv, ss.R, ss.Rb, D_vec, mu_vec, m_args, dinv,
                X, Rr, Z, Pp, rz, tol)
            iters += chunk_iters
            rn = np.asarray(rn_dev)
            col_iters[active] = iters
    from ..parallel.sweep import unpermute_columns
    Xout = unpermute_columns(sys, jnp.moveaxis(X, 0, 1))
    return Xout, {"iters": col_iters, "resnorm": rn,
                  "rel_resnorm": rn / np.where(bnorm > 0, bnorm, 1.0)}


# ---------------------------------------------------------------------------
# Sharded Stokes: block-preconditioned MINRES on the saddle system under
# the same device mesh.  The velocity stiffness and the divergence
# coupling are element-partitioned over "cells" (one fused psum per
# saddle apply); the (U (ns,2), p (np,)) iterate, the velocity V-cycle's
# mid/coarse levels, and the Schur-deflation basis are replicated --
# identical redundant vector math on every device beats communicating
# state that fits everywhere.  Matches the reference's latent MPI
# capability for its Stokes LU solve (ref solvers.py:291-298): the
# collectives run inside one jitted chunk.
# ---------------------------------------------------------------------------


class _ShardRectArgs(NamedTuple):
    """Divergence block split into per-"cells"-shard chunks; each chunk
    scatters locally into the FULL pressure / velocity index spaces
    (summed via one psum with the stiffness apply)."""
    Be: jnp.ndarray          # (tp, NB_loc, nr, ncol)
    rd: jnp.ndarray          # (tp, NB_loc, nr)    pressure rows
    cd: jnp.ndarray          # (tp, NB_loc, ncol)  2*ns interleaved cols
    rperm: jnp.ndarray
    rids: jnp.ndarray
    cperm: jnp.ndarray
    cids: jnp.ndarray


def _split_rect_block(Bargs, tp: int, np_pad: int, ns2: int):
    """Split padded (Be, rd, cd, ...) divergence arrays into tp chunks
    with per-chunk row/col scatter plans.  Padding entities carry zero
    matrices and scatter into the last (constrained) dofs -- no-ops."""
    Be = np.asarray(Bargs[0])
    rd = np.asarray(Bargs[1])
    cd = np.asarray(Bargs[2])
    NB, nr, ncol = Be.shape
    NB_loc = (NB + tp - 1) // tp
    NB_pad = NB_loc * tp
    if NB_pad > NB:
        Be = np.concatenate(
            [Be, np.zeros((NB_pad - NB, nr, ncol), Be.dtype)])
        rd = np.concatenate(
            [rd, np.full((NB_pad - NB, nr), np_pad - 1, rd.dtype)])
        cd = np.concatenate(
            [cd, np.full((NB_pad - NB, ncol), ns2 - 1, cd.dtype)])
    Bs, Rs, Cs, RPs, RIs, CPs, CIs = [], [], [], [], [], [], []
    for t in range(tp):
        sl = slice(t * NB_loc, (t + 1) * NB_loc)
        r = rd[sl]
        c = cd[sl]
        rids = r.ravel()
        rperm = np.argsort(rids, kind="stable")
        cids = c.ravel()
        cperm = np.argsort(cids, kind="stable")
        Bs.append(Be[sl]); Rs.append(r); Cs.append(c)
        RPs.append(rperm); RIs.append(rids[rperm])
        CPs.append(cperm); CIs.append(cids[cperm])
    return _ShardRectArgs(
        Be=jnp.asarray(np.stack(Bs)),
        rd=jnp.asarray(np.stack(Rs), dtype=jnp.int32),
        cd=jnp.asarray(np.stack(Cs), dtype=jnp.int32),
        rperm=jnp.asarray(np.stack(RPs), dtype=jnp.int32),
        rids=jnp.asarray(np.stack(RIs), dtype=jnp.int32),
        cperm=jnp.asarray(np.stack(CPs), dtype=jnp.int32),
        cids=jnp.asarray(np.stack(CIs), dtype=jnp.int32))


class ShardedStokes(NamedTuple):
    st: "object"             # models.stokes_flow.StokesSetup
    mesh_dev: Mesh
    K: _ShardBlockArgs       # velocity scalar-stiffness chunks (B=2)
    Bdiv: _ShardRectArgs
    m_args_v: "object"       # replicated velocity V-cycle args (f64)
    ns_pad: int
    np_pad: int


def _ml_spec_replicated(m_args):
    """PartitionSpecs for the velocity V-cycle args with EVERYTHING
    replicated (the Stokes iterate has no sweep axis; the cycle's fine
    level runs through the cells-sharded stiffness separately)."""
    levels, free_c, Ainv, D_vec, mu_vec, omega = m_args

    def _blk(b):
        return type(b)(P(), P(), P(), P(),
                       None if b.band is None else P())

    lev_specs = tuple(
        type(la)(K=_blk(la.K),
                 Adv=None if la.Adv is None else _blk(la.Adv),
                 R=None if la.R is None else _blk(la.R),
                 R_batch=None if la.R_batch is None else P(),
                 free=P(), dinv=P(), t_cols=P(), t_w=P(),
                 t_perm=P(), t_ids=P())
        for la in levels)
    return (lev_specs, P(), P(), P(), P(), P())


def build_sharded_stokes(mesh_data, H: float, device_mesh: Mesh,
                         level_factors=(3.0, 9.0)) -> ShardedStokes:
    """Partition the Stokes saddle system over the mesh's "cells" axis.

    Reuses the single-chip setup (_stokes_mg_setup: RCM-banded velocity
    system, level hierarchy, lumped pressure mass, coarse-pressure
    deflation) and splits only the two element blocks that carry the
    FLOPs.  f64 throughout -- this path exists for meshes exceeding one
    chip's HBM, where the defect-correction restarts of the mixed
    single-chip path would double the resident state.
    """
    from ..models.stokes_flow import _stokes_mg_setup
    from ..solvers.multilevel import ml_preconditioner_args
    st = _stokes_mg_setup(mesh_data, H, level_factors=level_factors)
    tp = device_mesh.shape["cells"]
    sysV = st.sysV
    K = _split_block(sysV.K, tp, sysV.ndofs, sysV.ndofs - 1)
    Bdiv = _split_rect_block(st.s64[1], tp, st.np_pad, 2 * st.ns_pad)
    m_args_v = ml_preconditioner_args(st.ml, f32=False, band=False)
    return ShardedStokes(st=st, mesh_dev=device_mesh, K=K, Bdiv=Bdiv,
                         m_args_v=m_args_v, ns_pad=st.ns_pad,
                         np_pad=st.np_pad)


def _stokes_shard_ops(sst: ShardedStokes):
    """Per-shard saddle apply + block preconditioner, and their specs."""
    st = sst.st
    ns_pad, np_pad = sst.ns_pad, sst.np_pad

    # reuse the transport-sharding machinery for the velocity V-cycle:
    # A_bc(Kb, None, None, ones, zeros, U) is the cells-psum vector
    # Laplacian, make_Mfn the sharded V-cycle around it
    ss_v = ShardedSystem(sys=st.sysV, mesh_dev=sst.mesh_dev, K=sst.K,
                         Adv=None, R=None, ml=st.ml, ml_K=sst.K)
    ops = _sharded_ops(ss_v, f32=False)
    make_Mfn, blk_spec = ops["make_Mfn"], ops["blk_spec"]

    free = st.sysV.free

    def S_impl(Kb, Bb, free_p, x):
        """Saddle apply [[A, B^T],[B, 0]] with identity on constrained
        rows; ONE fused psum("cells") carries all three partial sums."""
        U, p = x
        Um = jnp.where(free[:, None], U, 0.0)
        pm = jnp.where(free_p, p, 0.0)
        AU_loc = _local_apply(Kb, ns_pad, Um)
        Be, rd, cd = Bb.Be[0], Bb.rd[0], Bb.cd[0]
        pe = pm[rd]
        ye_t = jnp.einsum("nij,ni->nj", Be, pe,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=p.dtype)
        Btp_loc = jax.ops.segment_sum(
            ye_t.reshape(-1)[Bb.cperm[0]], Bb.cids[0],
            num_segments=2 * ns_pad, indices_are_sorted=True)
        xe = Um.reshape(-1)[cd]
        ye = jnp.einsum("nij,nj->ni", Be, xe,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=U.dtype)
        Bu_loc = jax.ops.segment_sum(
            ye.reshape(-1)[Bb.rperm[0]], Bb.rids[0],
            num_segments=np_pad, indices_are_sorted=True)
        AU, Btp_flat, Bu = jax.lax.psum((AU_loc, Btp_loc, Bu_loc),
                                        "cells")
        opU = jnp.where(free[:, None],
                        AU + Btp_flat.reshape(ns_pad, 2), U)
        return (opU, jnp.where(free_p, Bu, p))

    def M_impl(Kb, m_args_v, mp, Z, Cinv, x):
        """diag(MG(A) over cells, lumped Mp + Z Cinv Z^T replicated)."""
        U, p = x
        Mfn_v = make_Mfn(Kb, None, None, None, m_args_v, None)
        Mu = Mfn_v(U)
        dt = p.dtype
        Mp_p = mp.astype(dt) * p
        if Z is not None:
            Mp_p = Mp_p + jnp.matmul(
                Z.astype(dt), jnp.matmul(
                    Cinv.astype(dt),
                    jnp.matmul(Z.astype(dt).T, p, precision=_HI),
                    precision=_HI), precision=_HI)
        return (Mu, Mp_p)

    rect_spec = _ShardRectArgs(*([P("cells")] * 7))
    m_spec_v = _ml_spec_replicated(sst.m_args_v)
    x_spec = (P(), P())
    return dict(S_impl=S_impl, M_impl=M_impl, blk_spec=blk_spec,
                rect_spec=rect_spec, m_spec_v=m_spec_v, x_spec=x_spec)


_STOKES_SHARD_CACHE = {}


def _stokes_chunk_sharded(sst: ShardedStokes, n_iters: int, with_Z: bool):
    """Jitted shard_map MINRES chunk on the saddle pytree: the
    single-chip ESW recurrence (solvers/minres.py minres_body) runs
    replicated per device; only the saddle/V-cycle applies psum."""
    from ..solvers.minres import minres_body
    ops = _stokes_shard_ops(sst)
    S_impl, M_impl = ops["S_impl"], ops["M_impl"]
    blk_spec, rect_spec = ops["blk_spec"], ops["rect_spec"]
    m_spec_v, x_spec = ops["m_spec_v"], ops["x_spec"]

    def A_fn(a_args, x):
        Kb, Bb, free_p = a_args
        return S_impl(Kb, Bb, free_p, x)

    def M_fn(m_args, x):
        Kb, margs_v, mp, Z, Cinv = m_args
        return M_impl(Kb, margs_v, mp, Z, Cinv, x)

    body_maker = minres_body(A_fn, M_fn)

    def chunk_impl(a_args, m_args, state, tol):
        body = body_maker(a_args, m_args, tol)
        stf = jax.lax.fori_loop(0, n_iters, body, state)
        return stf, jnp.abs(stf[6])

    a_spec = (blk_spec, rect_spec, P())
    m_spec = (blk_spec, m_spec_v, P(),
              P() if with_Z else None, P() if with_Z else None)
    sc = P()
    state_spec = (x_spec, x_spec, x_spec, x_spec, sc, sc, sc,
                  sc, sc, sc, sc, x_spec, x_spec, sc)
    smap = dict(mesh=sst.mesh_dev,
                in_specs=(a_spec, m_spec, state_spec, sc),
                out_specs=(state_spec, sc))
    try:
        fn = shard_map(chunk_impl, check_vma=False, **smap)
    except TypeError:
        fn = shard_map(chunk_impl, check_rep=False, **smap)

    def apply_impl(a_args, m_args, x):
        Kb, Bb, free_p = a_args
        Sx = S_impl(Kb, Bb, free_p, x)
        Mx = M_fn(m_args, x)
        return Sx, Mx

    smap_a = dict(mesh=sst.mesh_dev,
                  in_specs=(a_spec, m_spec, x_spec),
                  out_specs=(x_spec, x_spec))
    try:
        ap = shard_map(apply_impl, check_vma=False, **smap_a)
    except TypeError:
        ap = shard_map(apply_impl, check_rep=False, **smap_a)
    return jax.jit(fn), jax.jit(ap)


def sharded_stokes_solve(sst: ShardedStokes, rtol=1e-9, maxiter=2000,
                         chunk_iters=80):
    """MINRES over the device mesh; returns (u, p, info) in
    FunctionSpace numbering, matching stokes_solve_mg's f64 path
    (vs-single equivalence pinned by tests/test_parallel.py)."""
    from ..fem.space import Function
    st = sst.st
    free_p = st.free_p
    margs64, mp64 = st.M64[1][0], st.M64[1][1]
    if len(st.M64[1]) == 4:
        Z64, Cinv64 = st.M64[1][2], st.M64[1][3]
    else:
        Z64 = Cinv64 = None

    key = (id(sst), chunk_iters)
    hit = _STOKES_SHARD_CACHE.get(key)
    if hit is not None and hit[0] is sst:
        chunk, ap = hit[1]
    else:
        chunk, ap = _stokes_chunk_sharded(sst, chunk_iters,
                                          Z64 is not None)
        _STOKES_SHARD_CACHE[key] = (sst, (chunk, ap))

    a_args = (sst.K, sst.Bdiv, free_p)
    m_args = (sst.K, sst.m_args_v, mp64, Z64, Cinv64)

    b = st.b
    x0 = jax.tree.map(jnp.zeros_like, b)
    Sx0, _ = ap(a_args, m_args, x0)
    v = jax.tree.map(lambda bi, si: bi - si, b, Sx0)
    _, Mv = ap(a_args, m_args, v)
    gam0 = float(jnp.sqrt(jnp.maximum(
        sum(jnp.sum(zi * vi) for zi, vi in zip(Mv, v)), 0.0)))
    zero = jnp.asarray(0.0, dtype=jnp.float64)
    one = jnp.asarray(1.0, dtype=jnp.float64)
    gam = jnp.asarray(gam0, dtype=jnp.float64)
    zv = jax.tree.map(jnp.zeros_like, b)
    state = (x0, zv, v, Mv, one, gam, gam,
             zero, zero, one, one, zv, zv, zero)
    tol = jnp.asarray(rtol * max(gam0, 1e-300), dtype=jnp.float64)

    dispatched = 0
    rn = gam0
    while dispatched < maxiter and rn > float(tol):
        state, rn_dev = chunk(a_args, m_args, state, tol)
        dispatched += chunk_iters
        rn = float(rn_dev)
    x = state[0]
    iters = int(state[-1])

    Sx, _ = ap(a_args, m_args, x)
    true_rn = float(jnp.sqrt(sum(
        jnp.sum((bi - si) ** 2) for bi, si in zip(b, Sx))))
    bnorm = float(jnp.sqrt(sum(jnp.sum(bi * bi) for bi in b)))

    U0, p_pad = x
    U = np.asarray(st.G + U0)
    if st.iperm_v is not None:
        U = U[np.asarray(st.iperm_v)[:st.ns_true]]
    u = Function(st.V, jnp.asarray(
        np.asarray(U[:st.ns_true]).reshape(-1)))
    p = Function(st.Q, jnp.asarray(np.asarray(p_pad[:st.np_true])))
    info = {"outer_iters": iters, "inner_iters": 0,
            "resnorm": true_rn,
            "rel_resnorm": true_rn / max(bnorm, 1e-300),
            "converged": bool(rn <= float(tol)),
            "method": "minres+mg+sharded"}
    u.solver_info = info
    p.solver_info = info
    return u, p, info
