"""Batched (vmapped) parameter sweeps -- the framework's data parallelism.

The reference runs every sweep point as a separate serial FEniCS solve
(SURVEY.md 2.3: e.g. no_advection_analysis_B.py:110-181 -- 138 sequential
solves).  Here a sweep shares one mesh/operator sparsity and the
coefficient dependence is factored out:

    A(D, mu) = D * K + Adv + R(mu)

K = unit stiffness, Adv = advection (fixed velocity field; note the
nondimensional Stokes field is Pe-independent, so ONE velocity solve feeds
every Pe point), R(mu) = mu * R_unit for scalar mu or per-sample facet
matrices for step-mu(x).  The whole sweep is ONE jitted vmapped batched
Krylov solve; gathers, batched small matmuls and segment-sums carry a batch
axis that amortises the irregular memory traffic.

Precision: 'f64', 'f32', or 'mixed' = f32 inner Krylov with f64
iterative refinement (solvers/mixed.py); default_precision() picks one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.assembly import (advection_block, make_bc, robin_facet_block,
                            stiffness_block)
from ..fem.space import FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..ops.elemspmv import ElementBlock, SumOperator
from ..solvers.bicgstab import bicgstab
from ..solvers.cg import cg
from ..solvers.mixed import refined_solve

__all__ = ["TransportSystem", "build_transport_system", "solve_sweep",
           "robin_matrices_for_mu", "default_precision",
           # legacy aliases used by tests / graft entry
    "build_mu_sweep_system", "solve_mu_sweep", "_solve_single",
           "MuSweepSystem"]


def default_precision(nonsym=False):
    """Krylov precision when the caller names none.  On an accelerator,
    symmetric (CG) sweeps run 'mixed' -- f32 inner CG with f64 defect
    correction on the element path -- which measured fastest on the H100
    (PERF.md); nonsymmetric (BiCGStab) sweeps, where pure f64 measured
    fastest, and the CPU run 'f64'."""
    if not nonsym and jax.default_backend() != "cpu":
        return "mixed"
    return "f64"


class _Block(NamedTuple):
    A64: jnp.ndarray
    A32: jnp.ndarray
    dofs: jnp.ndarray
    perm: jnp.ndarray
    ids_sorted: jnp.ndarray
    ndofs: int

    def apply(self, x, f32=False, A_override=None):
        A = A_override if A_override is not None else (
            self.A32 if f32 else self.A64)
        xe = x[self.dofs]
        ye = jnp.einsum("nij,nj->ni", A, xe,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=x.dtype)
        return jax.ops.segment_sum(
            ye.reshape(-1)[self.perm], self.ids_sorted,
            num_segments=self.ndofs, indices_are_sorted=True)

    def diagonal(self, A_override=None):
        A = A_override if A_override is not None else self.A64
        de = jnp.diagonal(A, axis1=1, axis2=2)
        return jax.ops.segment_sum(
            de.reshape(-1)[self.perm], self.ids_sorted,
            num_segments=self.ndofs, indices_are_sorted=True)

    def apply_batched(self, X, f32=False, A_override=None, coef=None):
        """(n, B) -> (n, B), batch in the minor (lane) dimension.

        A_override may be (N, nd, nd) shared or (B, N, nd, nd) per-sample;
        coef (B,) optionally fuses the per-column coefficient scaling.
        """
        A = A_override if A_override is not None else (
            self.A32 if f32 else self.A64)
        Xe = X[self.dofs]                         # (N, nd, B)
        # the nd=6 contraction is unrolled into elementwise multiply-adds:
        # exact f32/f64 arithmetic with no matmul-precision mode to pin
        Ac = A.astype(X.dtype)
        nd = Xe.shape[1]
        if Ac.ndim == 4:                          # per-sample matrices
            # Ye[n,i,b] = sum_j Ac[b,n,i,j] * Xe[n,j,b]
            Ye = jnp.stack(
                [sum(jnp.moveaxis(Ac[:, :, i, j], 0, 1)  # (N,B)
                     * Xe[:, j, :]
                     for j in range(nd))
                 for i in range(nd)], axis=1)      # (N, nd, B)
        else:
            Ye = jnp.stack(
                [sum(Ac[:, i, j, None] * Xe[:, j, :]
                     for j in range(nd))
                 for i in range(nd)], axis=1)      # (N, nd, B)
        if coef is not None:
            Ye = Ye * coef.astype(X.dtype)[None, None, :]
        N, nd, B = Ye.shape
        return jax.ops.segment_sum(
            Ye.reshape(N * nd, B)[self.perm], self.ids_sorted,
            num_segments=self.ndofs, indices_are_sorted=True)

    def diagonal_batched(self, A_batch):
        """Per-sample diagonals: (B, N, nd, nd) -> (n, B)."""
        de = jnp.diagonal(A_batch, axis1=2, axis2=3)       # (B, N, nd)
        B = de.shape[0]
        de = jnp.moveaxis(de.reshape(B, -1), 0, 1)         # (N*nd, B)
        return jax.ops.segment_sum(
            de[self.perm], self.ids_sorted,
            num_segments=self.ndofs, indices_are_sorted=True)


def _from_element_block(b: ElementBlock) -> _Block:
    return _Block(A64=b.A_e, A32=b.A_e.astype(jnp.float32),
                  dofs=b.entity_dofs, perm=b.scatter.perm,
                  ids_sorted=b.scatter.ids_sorted,
                  ndofs=b.scatter.ndofs)


class TransportSystem(NamedTuple):
    K: _Block
    Adv: Optional[_Block]
    R: Optional[_Block]          # unit-mu Robin
    free: jnp.ndarray
    bc_values: jnp.ndarray
    ndofs: int
    space: "object"
    # banded-dense operator form (ops/banded.py); populated when
    # the system is RCM-permuted.  perm = new2old, iperm = old2new.
    Kband: Optional[jnp.ndarray] = None      # (T, R, W) f32
    Advband: Optional[jnp.ndarray] = None
    perm: Optional[np.ndarray] = None
    iperm: Optional[np.ndarray] = None


def unpermute_columns(sys: TransportSystem, Xcols):
    """(B, ndofs) solution columns (system numbering) -> (B, n_true)
    in the FunctionSpace's dof numbering."""
    n_true = sys.space.ndofs
    if sys.iperm is None:
        return Xcols[:, :n_true]
    return Xcols[:, jnp.asarray(sys.iperm[:n_true])]


def _bucket(n, granularity=4096):
    """Round n up to a quantized size so kernel shapes are shared across
    meshes.  Each distinct shape is a fresh compile; geometry sweeps over
    23 meshes would otherwise recompile everything per geometry."""
    return ((n + granularity - 1) // granularity) * granularity


def _permute_block(b: _Block, old2new: np.ndarray) -> _Block:
    """Renumber a block's dofs (scatter plan rebuilt on host)."""
    dofs = old2new[np.asarray(b.dofs, dtype=np.int64)]
    ids = dofs.ravel()
    perm = np.argsort(ids, kind="stable")
    return _Block(A64=b.A64, A32=b.A32,
                  dofs=jnp.asarray(dofs, dtype=jnp.int32),
                  perm=jnp.asarray(perm, dtype=jnp.int32),
                  ids_sorted=jnp.asarray(ids[perm], dtype=jnp.int32),
                  ndofs=b.ndofs)


# host-side permutation + scatter-plan bundles, cached per mesh/element
# in mesh.info (value-independent, lifetime tied to the mesh; rebuilt
# band ARRAYS are cheap device scatters)
# Band tile rows: the band's bytes are n*(2*ceil(spread/R)+1)*R*4, so
# smaller tiles track the graph spread more tightly, larger ones mean
# fewer tiles.  At the study scale (1e5 P2 dofs, spread ~357 after the
# geometric ordering) 256 rows gives a (416, 256, 1280) f32 band.
_BAND_TILE = 256


def _band_plans_for(mesh, element, K: _Block, Adv, R, ndofs, n_true,
                    dof_coords=None):
    from ..ops.banded import (build_band_plan,
                              best_bandwidth_permutation)
    key = ("band_plan", element, ndofs, K.A64.shape[0],
           None if Adv is None else Adv.A64.shape[0],
           None if R is None else R.A64.shape[0], _BAND_TILE)
    def _fresh(tmpl, blk):
        # re-attach current VALUE arrays to the cached dof/scatter plan
        # (Adv values change per velocity field on the same mesh)
        if tmpl is None or blk is None:
            return None
        return tmpl._replace(A64=blk.A64, A32=blk.A32)

    hit = mesh.info.get(key) if isinstance(mesh.info, dict) else None
    if hit is not None:
        new2old, old2new, Kp, Advp, Rp, plan_K = hit
        return (new2old, old2new, _fresh(Kp, K), _fresh(Advp, Adv),
                _fresh(Rp, R), plan_K)
    new2old, old2new = best_bandwidth_permutation(
        np.asarray(K.dofs), dof_coords, n_true, ndofs)
    Kp = _permute_block(K, old2new)
    Advp = None if Adv is None else _permute_block(Adv, old2new)
    Rp = None if R is None else _permute_block(R, old2new)
    plan_K = build_band_plan(np.asarray(Kp.dofs), ndofs, tile=_BAND_TILE)
    if isinstance(mesh.info, dict):
        mesh.info[key] = (new2old, old2new, Kp, Advp, Rp, plan_K)
    return (new2old, old2new, Kp, Advp, Rp, plan_K)


def _system_cache_key(mesh, element, u_values, u_space, robin_degree,
                      pad_shapes, dirichlet, with_robin, pad_granularity,
                      band):
    """Content key for the assembled-system disk cache, or None when an
    input can't be hashed deterministically (callable dirichlet)."""
    if dirichlet is None:
        bc_part = "default"
    else:
        try:
            bc_part = repr([(int(m), float(v)) for m, v in dirichlet])
        except (TypeError, ValueError):
            return None
    from ..utils.diskcache import cache_key_of
    import os as _os
    return cache_key_of(
        "tsys-v3",   # v3: sparser band-halo menu (ops/banded.py)
        np.asarray(mesh.vertices), np.asarray(mesh.cells),
        np.asarray(mesh.bc_marker), element,
        None if u_values is None else np.asarray(u_values),
        None if u_space is None else (u_space.element, u_space.vs),
        robin_degree, bool(pad_shapes), bc_part, bool(with_robin),
        pad_granularity, band, _BAND_TILE,
        _os.environ.get("FEU_BAND", "1"))


def _system_to_arrays(sys: TransportSystem):
    out = {"ndofs": int(sys.ndofs),
           "free": np.asarray(sys.free),
           "bc_values": np.asarray(sys.bc_values)}
    for name in ("K", "Adv", "R"):
        b = getattr(sys, name)
        if b is None:
            continue
        out[f"{name}_A64"] = np.asarray(b.A64)
        out[f"{name}_dofs"] = np.asarray(b.dofs)
        out[f"{name}_perm"] = np.asarray(b.perm)
        out[f"{name}_ids"] = np.asarray(b.ids_sorted)
        out[f"{name}_ndofs"] = int(b.ndofs)
    for name in ("Kband", "Advband", "perm", "iperm"):
        v = getattr(sys, name)
        if v is not None:
            out[name] = np.asarray(v)
    return out


def _system_from_arrays(d, mesh, element):
    space = FunctionSpace(mesh, element)

    def block(name):
        if f"{name}_A64" not in d:
            return None
        A64 = jnp.asarray(d[f"{name}_A64"])
        return _Block(A64=A64, A32=A64.astype(jnp.float32),
                      dofs=jnp.asarray(d[f"{name}_dofs"]),
                      perm=jnp.asarray(d[f"{name}_perm"]),
                      ids_sorted=jnp.asarray(d[f"{name}_ids"]),
                      ndofs=int(d[f"{name}_ndofs"]))

    def opt(name, as_np=False):
        v = d.get(name)
        if v is None:
            return None
        return v if as_np else jnp.asarray(v)

    return TransportSystem(
        K=block("K"), Adv=block("Adv"), R=block("R"),
        free=jnp.asarray(d["free"]),
        bc_values=jnp.asarray(d["bc_values"]), ndofs=int(d["ndofs"]),
        space=space, Kband=opt("Kband"), Advband=opt("Advband"),
        perm=opt("perm", as_np=True), iperm=opt("iperm", as_np=True))


def build_transport_system(mesh: MeshData, element="P2",
                           u_values=None, u_space=None,
                           robin_degree=None,
                           pad_shapes=False,
                           dirichlet=None,
                           with_robin=True,
                           pad_granularity=None,
                           band=None,
                           disk_cache=False) -> TransportSystem:
    """Assemble the sweep system.  pad_shapes buckets the cell/facet/dof
    counts so compiled kernels are shared across meshes of similar size,
    and enables the banded operator form (FEU_BAND).

    dirichlet: list of (marker_id, value) pairs; defaults to the
    transport BCs c=1 left / c=0 right (ref solvers.py:127-129).
    with_robin=False skips the Robin facet block (e.g. the Stokes
    velocity Laplacian, whose walls are Dirichlet).
    pad_granularity: (dofs, cells, facets) bucket sizes; the default
    (8192, 4096, 512) suits study-scale fine meshes -- the small MG
    level systems use finer buckets."""
    ck = None
    memo_key = None
    if disk_cache:
        ck = _system_cache_key(mesh, element, u_values, u_space,
                               robin_degree, pad_shapes, dirichlet,
                               with_robin, pad_granularity, band)
        if ck is not None:
            # in-process memo ABOVE the disk cache: a warm study/bench
            # rebuild for a geometry already assembled this process
            # (e.g. per-geometry MG setup) skips the npz read +
            # FunctionSpace + array conversions entirely (~1.1 s of the
            # warm build_multilevel floor).  Keyed also by the effective
            # device so the CPU-built level systems never leak into a
            # different placement context.
            dev = getattr(jax.config, "jax_default_device", None)
            memo_key = (ck, str(dev), jax.default_backend())
            hit = _TSYS_MEMO.get(memo_key)
            if hit is not None:
                return hit
            from ..utils.diskcache import load_arrays
            hit = load_arrays("tsys", ck)
            if hit is not None:
                out = _system_from_arrays(hit, mesh, element)
                _tsys_memo_put(memo_key, out)
                return out
    import os as _os
    import time as _time
    _dbg = _os.environ.get("FEU_TIMING") == "1"
    # First build of a shape class: drain the dispatch queue at every
    # stage boundary, so each stage's compile and run finish before the
    # next stage is queued.  Warm rebuilds of an already-seen shape class
    # skip the drains and keep host/device overlap.
    # (_cold is set once pad_c/pad_r are known, below.)
    _cold = True

    def _t(msg, t0, sync=None):
        if sync is not None and (_cold or _dbg):
            jax.block_until_ready(sync)
        if _dbg:
            print(f"[build_tsys] {msg}: {_time.time() - t0:.2f}s",
                  flush=True)
        return _time.time()

    _tt = _time.time()
    space = FunctionSpace(mesh, element)
    bottom = mesh.bc_marker == MARKERS["bottom"]
    _tt = _t("space", _tt)

    # assemble AT the bucket shapes (host-padded inputs): every device
    # einsum in the assembly then compiles once per shape class instead
    # of once per raw mesh (measured ~35 fresh XLA compiles = ~50 s per
    # NEW geometry when assembling at raw sizes; multi-geometry studies
    # hit that for every point)
    pad_c = pad_r = None
    if pad_shapes:
        g_dof, g_cell, g_facet = pad_granularity or (8192, 4096, 512)
        ndofs_p = _bucket(space.ndofs + 1, g_dof)  # +1: dummy dof room
        dummy = space.ndofs                        # first padding dof
        pad_c = (_bucket(len(mesh.cells), g_cell), ndofs_p, dummy,
                 _bucket(len(mesh.vertices) + 3, g_cell))
        pad_r = (_bucket(int(bottom.sum()), g_facet), ndofs_p, dummy)
    _shape_key = (element, pad_c, pad_r, u_values is not None)
    _cold = _shape_key not in _BUILT_SHAPES
    _BUILT_SHAPES.add(_shape_key)

    K = _from_element_block(stiffness_block(space, D=1.0, pad=pad_c))
    _tt = _t("stiffness", _tt, sync=K.A32)
    Adv = None
    if u_values is not None:
        Adv = _from_element_block(
            advection_block(space, u_values, u_space, pad=pad_c))
        _tt = _t("advection", _tt, sync=Adv.A32)
    R = None
    if with_robin and bottom.any():
        kw = {} if robin_degree is None else {"degree": robin_degree}
        R = _from_element_block(robin_facet_block(space, bottom, mu=1.0,
                                                  pad=pad_r, **kw))
        _tt = _t("robin", _tt, sync=R.A32)
    if dirichlet is None:
        dirichlet = [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)]
    bc = make_bc(space, dirichlet)
    free = bc.free
    bc_values = bc.values
    ndofs = space.ndofs

    # keep free/bc_values as HOST arrays until the final conversion:
    # the pad-concat and the band permutation below are then pure numpy
    # (each jnp op here is an eager device round-trip in the cold path)
    free = np.asarray(free)
    bc_values = np.asarray(bc_values)
    if pad_shapes:
        pad = ndofs_p - ndofs
        # padding dofs are constrained to 0 (identity rows, zero rhs)
        free = np.concatenate([free, np.zeros(pad, dtype=bool)])
        bc_values = np.concatenate([bc_values, np.zeros(pad)])
        ndofs = ndofs_p

    if band is None:
        band = (pad_shapes and ndofs % _BAND_TILE == 0
                and _os.environ.get("FEU_BAND", "1") == "1")
    Kband = Advband = perm = iperm = None
    if band and ndofs % _BAND_TILE == 0:
        from ..ops.banded import band_from_elements
        perm, iperm, K, Adv, R, plan_K = _band_plans_for(
            mesh, element, K, Adv, R, ndofs, space.ndofs,
            dof_coords=np.asarray(space.dof_coords))
        _tt = _t("band plans", _tt)
        free = free[np.asarray(perm)]
        bc_values = bc_values[np.asarray(perm)]
        Kband = band_from_elements(K.A32, plan_K)
        if Adv is not None:
            Advband = band_from_elements(Adv.A32, plan_K)
        _tt = _t("band scatter", _tt, sync=Kband)

    out = TransportSystem(K=K, Adv=Adv, R=R, free=jnp.asarray(free),
                          bc_values=jnp.asarray(bc_values), ndofs=ndofs,
                          space=space, Kband=Kband, Advband=Advband,
                          perm=perm, iperm=iperm)
    _tt = _t("finalize", _tt, sync=(out.free, out.K.A64))
    if ck is not None:
        from ..utils.diskcache import store_arrays
        store_arrays("tsys", ck, _system_to_arrays(out))
        if memo_key is not None:
            _tsys_memo_put(memo_key, out)
    return out


_TSYS_MEMO: dict = {}

# shape classes already built this process (stage-drain bookkeeping)
_BUILT_SHAPES: set = set()


def _tsys_memo_put(key, sys_out, cap=24):
    """Bounded FIFO memo for disk-cached level systems (the MG levels of
    the ~3 live geometries of a study step; each is a few MB of host
    arrays)."""
    _TSYS_MEMO[key] = sys_out
    while len(_TSYS_MEMO) > cap:
        _TSYS_MEMO.pop(next(iter(_TSYS_MEMO)))


def robin_matrices_for_mu(sys: TransportSystem, mu, degree=None):
    """Per-facet Robin matrices for a spatially-varying mu(x) callable.

    Assembled at the system's padded facet count when sys is padded, so
    the device einsum shape is shared across geometries and the result
    aligns with sys.R without re-padding."""
    mesh = sys.space.mesh
    bottom = mesh.bc_marker == MARKERS["bottom"]
    kw = {} if degree is None else {"degree": degree}
    pad = None
    if sys.R is not None and sys.ndofs > sys.space.ndofs:
        pad = (sys.R.A64.shape[0], sys.ndofs, sys.space.ndofs)
    return robin_facet_block(sys.space, bottom, mu=mu, pad=pad,
                             **kw).A_e


def _solve_one_factory(sys: TransportSystem, rtol, maxiter, precision):
    """Builds solve_one(D, mu, R_e) -> (x, iters, resnorm).

    R_e: per-sample Robin element matrices (f64) or None -> mu * R_unit.
    """
    free64 = sys.free
    g64 = sys.bc_values
    g32 = g64.astype(jnp.float32)
    nonsym = sys.Adv is not None

    def A_raw(D, mu, R_e, x, f32):
        # coefficients follow the vector dtype so the f32 path stays f32
        Dc = jnp.asarray(D).astype(x.dtype)
        y = Dc * sys.K.apply(x, f32)
        if sys.Adv is not None:
            y = y + sys.Adv.apply(x, f32)
        if sys.R is not None:
            if R_e is None:
                muc = jnp.asarray(mu).astype(x.dtype)
                y = y + muc * sys.R.apply(x, f32)
            else:
                y = y + sys.R.apply(
                    x, f32, A_override=R_e.astype(x.dtype))
        return y

    def make_A(D, mu, R_e, f32):
        def A(x):
            y = A_raw(D, mu, R_e, jnp.where(free64, x, 0.0), f32)
            return jnp.where(free64, y, x)
        return A

    def diag(D, mu, R_e):
        d = D * sys.K.diagonal()
        if sys.Adv is not None:
            d = d + sys.Adv.diagonal()
        if sys.R is not None:
            d = d + (mu * sys.R.diagonal() if R_e is None
                     else sys.R.diagonal(A_override=R_e))
        return d

    def solve_one(D, mu, R_e):
        rhs64 = jnp.where(free64, -A_raw(D, mu, R_e, g64, False), g64)
        d = diag(D, mu, R_e)
        dinv = jnp.where(free64 & (d != 0),
                         1.0 / jnp.where(d != 0, d, 1.0), 1.0)
        if precision == "f64":
            M = lambda r: dinv * r
            A = make_A(D, mu, R_e, False)
            krylov = bicgstab if nonsym else cg
            res = krylov(A, rhs64, M=M, rtol=rtol, maxiter=maxiter)
            return res.x, res.iters, res.resnorm
        if precision == "f32":
            dinv32 = dinv.astype(jnp.float32)
            A = make_A(D.astype(jnp.float32) if hasattr(D, "astype") else D,
                       mu, R_e, True)
            krylov = bicgstab if nonsym else cg
            res = krylov(A, rhs64.astype(jnp.float32),
                         M=lambda r: dinv32 * r,
                         rtol=max(rtol, 1e-6), maxiter=maxiter)
            return (res.x.astype(jnp.float64), res.iters, res.resnorm)
        # mixed: f32 inner + f64 refinement
        dinv32 = dinv.astype(jnp.float32)
        A64 = make_A(D, mu, R_e, False)
        A32 = make_A(jnp.asarray(D, dtype=jnp.float32), mu, R_e, True)
        res = refined_solve(A64, A32, rhs64, M32=lambda r: dinv32 * r,
                            rtol=rtol, inner_rtol=1e-4,
                            inner_maxiter=maxiter,
                            nonsymmetric=nonsym)
        return res.x, res.inner_iters, res.resnorm

    return solve_one


class _FusedOperator(NamedTuple):
    """The whole A(D_b, mu_b) as ONE per-sample element array.

    The separate K/Adv/R applies cost one gather+scatter each, so the
    sweep coefficients are baked into a single fused entity array A_f[b] = [D_b K_e + Adv_e ; mu_b R_e]
    (cells then facets) applied with ONE gather -> per-sample matmul ->
    ONE scatter per Krylov iteration.
    """

    A64: jnp.ndarray          # (nd, nd, N_total, B)
    A32: jnp.ndarray
    dofs: jnp.ndarray         # (N_total, nd)
    perm: jnp.ndarray
    ids_sorted: jnp.ndarray
    ndofs: int

    def apply(self, X, f32):
        A = self.A32 if f32 else self.A64
        return _fused_apply_impl(A, self.dofs, self.perm,
                                 self.ids_sorted, self.ndofs, X)


def _fused_apply_impl(A, dofs, perm, ids_sorted, ndofs, X):
    """Ye[n,i,b] = sum_j A[i,j,n,b] * X[dofs[n,j],b]; one scatter total."""
    Xe = X[dofs]                                   # (N, nd, B)
    Ac = A.astype(X.dtype)
    nd = Xe.shape[1]
    Ye = jnp.stack(
        [sum(Ac[i, j] * Xe[:, j, :] for j in range(nd))
         for i in range(nd)], axis=1)              # (N, nd, B)
    N, _, B = Ye.shape
    return jax.ops.segment_sum(
        Ye.reshape(N * nd, B)[perm], ids_sorted,
        num_segments=ndofs, indices_are_sorted=True)


def _build_fused(sys: TransportSystem, D_vec, mu_vec, R_batch):
    """Fuse K/Adv/R with the sweep coefficients into one element array."""
    import numpy as _np
    parts64 = []
    dofs_parts = []
    B = int(D_vec.shape[0])
    K_b = D_vec[:, None, None, None] * sys.K.A64[None]
    if sys.Adv is not None:
        K_b = K_b + sys.Adv.A64[None]
    parts64.append(K_b)
    dofs_parts.append(_np.asarray(sys.K.dofs))
    if sys.R is not None:
        if R_batch is None:
            parts64.append(mu_vec[:, None, None, None] * sys.R.A64[None])
        else:
            parts64.append(R_batch.astype(sys.R.A64.dtype))
        dofs_parts.append(_np.asarray(sys.R.dofs))
    A64 = jnp.concatenate(parts64, axis=1)         # (B, N_total, nd, nd)
    # layout (nd, nd, N, B): each contraction term is then a contiguous
    # (N, B) plane
    A64 = jnp.transpose(A64, (2, 3, 1, 0))        # (nd, nd, N, B)
    dofs = _np.concatenate(dofs_parts, axis=0)
    ids = dofs.ravel()
    perm = _np.argsort(ids, kind="stable")
    return _FusedOperator(
        A64=A64, A32=A64.astype(jnp.float32),
        dofs=jnp.asarray(dofs, dtype=jnp.int32),
        perm=jnp.asarray(perm, dtype=jnp.int32),
        ids_sorted=jnp.asarray(ids[perm], dtype=jnp.int32),
        ndofs=sys.ndofs)


def _batched_operator(sys: TransportSystem, D_vec, mu_vec, R_batch, f32,
                      fused=None):
    """A(X): (n,B)->(n,B) with per-column coefficients, plus diag (n,B)."""
    free = sys.free

    if fused is not None:
        def A_raw(X):
            return fused.apply(X, f32)
    else:
        def A_raw(X):
            Y = sys.K.apply_batched(X, f32, coef=D_vec)
            if sys.Adv is not None:
                Y = Y + sys.Adv.apply_batched(X, f32)
            if sys.R is not None:
                if R_batch is None:
                    Y = Y + sys.R.apply_batched(X, f32, coef=mu_vec)
                else:
                    Y = Y + sys.R.apply_batched(X, f32,
                                                A_override=R_batch)
            return Y

    def A(X):
        Y = A_raw(jnp.where(free[:, None], X, 0.0))
        return jnp.where(free[:, None], Y, X)

    diag = D_vec[None, :] * sys.K.diagonal()[:, None]
    if sys.Adv is not None:
        diag = diag + sys.Adv.diagonal()[:, None]
    if sys.R is not None:
        if R_batch is None:
            diag = diag + mu_vec[None, :] * sys.R.diagonal()[:, None]
        else:
            diag = diag + sys.R.diagonal_batched(R_batch)
    return A_raw, A, diag


# ---------------------------------------------------------------------------
# Stable operator programs.
#
# EVERYTHING variable -- element matrices, gather/scatter plans, Dirichlet
# masks, sweep coefficients -- enters the jitted Krylov chunks as
# ARGUMENTS.  Closure constants would (a) re-trace + recompile whenever a
# mu batch or mesh changes (measured round 2: the whole "steady" solve was
# re-compiling) and (b) defeat shape bucketing: with arrays as arguments,
# every mesh in the same size bucket shares ONE compiled chunk.  Function
# objects are cached by STRUCTURE key so solvers/batched.py's chunk cache
# hits across solve_sweep calls, meshes, and studies.
# ---------------------------------------------------------------------------

_PROG_CACHE: Dict[tuple, tuple] = {}


class _BlockArgs(NamedTuple):
    """One element block's arrays, as runtime arguments.

    band: optional (T, R, W) banded-dense form (ops/banded.py); when
    present the f32 apply runs as batched dense tile matmuls instead of
    gather/einsum/scatter."""
    A: jnp.ndarray
    dofs: jnp.ndarray
    perm: jnp.ndarray
    ids_sorted: jnp.ndarray
    band: Optional[jnp.ndarray] = None

    @classmethod
    def of(cls, b: _Block, f32: bool, band=None):
        return cls(A=b.A32 if f32 else b.A64, dofs=b.dofs, perm=b.perm,
                   ids_sorted=b.ids_sorted,
                   band=band if f32 else None)


def _args_block_apply(ba: _BlockArgs, ndofs: int, X, coef=None,
                      A_batch=None):
    """_Block.apply_batched with the arrays taken from arguments."""
    if ba.band is not None and A_batch is None:
        from ..ops.banded import band_apply
        return band_apply(ba.band, X, coef=coef)
    blk = _Block(A64=ba.A, A32=ba.A, dofs=ba.dofs, perm=ba.perm,
                 ids_sorted=ba.ids_sorted, ndofs=ndofs)
    return blk.apply_batched(
        X, f32=False, coef=coef,
        A_override=None if A_batch is None else A_batch.astype(X.dtype))


def sys_struct_key(sys: TransportSystem):
    """Shape-bucket structure key: meshes in the same bucket share it."""
    return (sys.ndofs,
            sys.K.A64.shape[0],
            None if sys.Adv is None else sys.Adv.A64.shape[0],
            None if sys.R is None else sys.R.A64.shape[0],
            None if sys.Kband is None else tuple(sys.Kband.shape))


def operator_args(sys: TransportSystem, D_vec, mu_vec, R_batch, f32: bool):
    """The runtime argument pytree for _operator_program's functions."""
    dt = jnp.float32 if f32 else jnp.float64
    return (
        _BlockArgs.of(sys.K, f32, band=sys.Kband),
        None if sys.Adv is None else _BlockArgs.of(sys.Adv, f32,
                                                   band=sys.Advband),
        None if sys.R is None else _BlockArgs.of(sys.R, f32),
        sys.free,
        D_vec.astype(dt),
        mu_vec.astype(dt),
        None if R_batch is None else R_batch.astype(dt),
    )


def _operator_program(struct_key):
    """Returns (A_fn, rhs_fn, residual_fn, diag_fn); each takes the
    operator_args(...) pytree as its first argument."""
    hit = _PROG_CACHE.get(struct_key)
    if hit is not None:
        return hit
    ndofs = struct_key[0]

    def A_raw(a, X):
        K, Adv, R, free, D_vec, mu_vec, R_batch = a
        Y = _args_block_apply(K, ndofs, X, coef=D_vec.astype(X.dtype))
        if Adv is not None:
            Y = Y + _args_block_apply(Adv, ndofs, X)
        if R is not None:
            if R_batch is None:
                Y = Y + _args_block_apply(R, ndofs, X,
                                          coef=mu_vec.astype(X.dtype))
            else:
                Y = Y + _args_block_apply(R, ndofs, X, A_batch=R_batch)
        return Y

    def A_fn(a, X):
        free = a[3]
        Y = A_raw(a, jnp.where(free[:, None], X, 0.0))
        return jnp.where(free[:, None], Y, X)

    @jax.jit
    def rhs_fn(a, G):
        free = a[3]
        return jnp.where(free[:, None], -A_raw(a, G), G)

    @jax.jit
    def residual_fn(a, RHS, X):
        Rr = RHS - A_fn(a, X)
        return Rr, jnp.linalg.norm(Rr, axis=0)

    def _block_diag(ba: _BlockArgs):
        blk = _Block(A64=ba.A, A32=ba.A, dofs=ba.dofs, perm=ba.perm,
                     ids_sorted=ba.ids_sorted, ndofs=ndofs)
        return blk.diagonal(A_override=ba.A)

    @jax.jit
    def diag_fn(a):
        K, Adv, R, free, D_vec, mu_vec, R_batch = a
        d = D_vec[None, :] * _block_diag(K)[:, None]
        if Adv is not None:
            d = d + _block_diag(Adv)[:, None]
        if R is not None:
            if R_batch is None:
                d = d + mu_vec[None, :] * _block_diag(R)[:, None]
            else:
                blk = _Block(A64=R.A, A32=R.A, dofs=R.dofs, perm=R.perm,
                             ids_sorted=R.ids_sorted, ndofs=ndofs)
                d = d + blk.diagonal_batched(R_batch)
        dinv = jnp.where(free[:, None] & (d != 0),
                         1.0 / jnp.where(d != 0, d, 1.0), 1.0)
        return dinv

    prog = (A_fn, rhs_fn, residual_fn, diag_fn)
    _PROG_CACHE[struct_key] = prog
    return prog


# whole-refinement-pass programs: ONE device dispatch per mixed-precision
# pass (f64 residual -> f32 preconditioned CG with per-column early exit
# -> f64 update -> fresh f64 residual norms) instead of ~8 eager
# dispatches per pass.
_REFINE_CACHE: Dict[tuple, "object"] = {}


def _jacobi_M(m_args, R):
    return m_args[0] * R


def _refine_program(struct_key, M_fn, n_iters):
    key = (struct_key, id(M_fn), n_iters)
    hit = _REFINE_CACHE.get(key)
    if hit is not None and hit[0] is M_fn:
        return hit[1]
    A_fn, _, _, _ = _operator_program(struct_key)

    @jax.jit
    def refine(a64, a32, m_args, RHS, X, tol, inner_rtol):
        R64 = RHS - A_fn(a64, X)
        rn0 = jnp.sqrt(jnp.sum(R64 * R64, axis=0))
        R = R64.astype(jnp.float32)
        tol_in = jnp.maximum(inner_rtol * rn0,
                             0.1 * tol).astype(jnp.float32)
        Z = M_fn(m_args, R)
        P = Z
        rz = jnp.sum(R * Z, axis=0)
        Dx = jnp.zeros_like(R)
        it0 = jnp.zeros(R.shape[1], dtype=jnp.int32)

        def cond(st):
            i, Dx, R, Z, P, rz, cit = st
            rn = jnp.sqrt(jnp.sum(R * R, axis=0))
            return (i < n_iters) & jnp.any(rn > tol_in)

        def body(st):
            i, Dx, R, Z, P, rz, cit = st
            active = jnp.sqrt(jnp.sum(R * R, axis=0)) > tol_in
            AP = A_fn(a32, P)
            pAp = jnp.sum(P * AP, axis=0)
            alpha = jnp.where(active & (pAp != 0),
                              rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
            Dx = Dx + alpha[None, :] * P
            R = R - alpha[None, :] * AP
            Z = M_fn(m_args, R)
            rz_new = jnp.sum(R * Z, axis=0)
            beta = jnp.where(active & (rz != 0),
                             rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
            P = jnp.where(active[None, :], Z + beta[None, :] * P, P)
            return (i + 1, Dx, R, Z, P, rz_new,
                    cit + active.astype(jnp.int32))

        _, Dx, R, Z, P, rz, cit = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), Dx, R, Z, P, rz,
                         it0))
        X_new = X + Dx.astype(jnp.float64)
        R64n = RHS - A_fn(a64, X_new)
        rn = jnp.sqrt(jnp.sum(R64n * R64n, axis=0))
        return X_new, rn, cit

    _REFINE_CACHE[key] = (M_fn, refine)
    return refine


def _cheap_passes():
    """Defect passes carried on the inner CG's own recurrence residual
    (zero f64 element applies at the pass boundary) before the one
    true-residual certification.  The f64 element apply is the single
    most expensive dispatch in the solve (the f64 gather/scatter path
    has no banded form).

    Drift analysis pins the structure: a cheap pass STARTED at full
    residual scale admits ~2^-24 * ||b|| of f32 recurrence drift --
    above rtol=1e-11 -- so the loop always opens with ONE true f64
    pass; from pass 2 on the starting scale is ~1e-4 ||b|| and the
    carried residual is trustworthy to ~1e-11 ||b||.  (The first
    attempt without the leading true pass paid 2 extra fallback passes
    and was a net loss.)  The carried estimate is never reported: one
    true f64 residual after the cheap loop certifies the norms, and
    the classic true-residual passes below it mop up any miss.

    Default 0, so the test/artifact pass structure stays pinned
    (FEU_CHEAP_PASSES overrides)."""
    import os
    return int(os.environ.get("FEU_CHEAP_PASSES", "0"))


def _mixed_solve_program(struct_key, M_fn, n_iters, max_passes=10,
                         x0_lift=False, cheap_passes=None):
    """The ENTIRE mixed-precision solve as one device dispatch: an outer
    f64 defect-correction while_loop, each pass an early-exit f32
    preconditioned-CG while_loop.  Only the final X and (B,) diagnostics
    cross the host boundary.

    x0_lift: X0 is the Dirichlet lifting vector (zero on every free
    dof), so the opening residual is analytically where(free, RHS, 0)
    -- this skips one f64 element apply, the single most expensive
    dispatch in the program (the f64 gather/scatter path has no banded
    form).

    cheap_passes: the first passes carry the inner CG's OWN final f32
    recurrence residual (cast to f64) across the pass boundary instead
    of recomputing the true f64 residual -- zero element applies per
    boundary.  The f32 drift this admits is ~2^-24 * ||R_prev|| per
    pass (pass 1's ||R|| ~ 1e-4 ||b|| bounds it by ~1e-11 ||b||), and
    it is never trusted: ONE true f64 residual after the cheap loop
    certifies the reported norms, and the classic true-residual passes
    below it mop up any certification miss."""
    if cheap_passes is None:
        cheap_passes = _cheap_passes()
    key = ("mixed", struct_key, id(M_fn), n_iters, max_passes, x0_lift,
           cheap_passes)
    hit = _REFINE_CACHE.get(key)
    if hit is not None and hit[0] is M_fn:
        return hit[1]
    A_fn, _, _, _ = _operator_program(struct_key)

    @jax.jit
    def solve(a64, a32, m_args, RHS, X0, tol, inner_rtol):
        B = RHS.shape[1]

        def inner(R64):
            rn0 = jnp.sqrt(jnp.sum(R64 * R64, axis=0))
            R = R64.astype(jnp.float32)
            tol_in = jnp.maximum(inner_rtol * rn0,
                                 0.1 * tol).astype(jnp.float32)
            Z = M_fn(m_args, R)
            P = Z
            rz = jnp.sum(R * Z, axis=0)
            Dx = jnp.zeros_like(R)
            cit0 = jnp.zeros(B, dtype=jnp.int32)

            def cond(st):
                i, Dx, R, Z, P, rz, cit = st
                rn = jnp.sqrt(jnp.sum(R * R, axis=0))
                return (i < n_iters) & jnp.any(rn > tol_in)

            def body(st):
                i, Dx, R, Z, P, rz, cit = st
                active = jnp.sqrt(jnp.sum(R * R, axis=0)) > tol_in
                AP = A_fn(a32, P)
                pAp = jnp.sum(P * AP, axis=0)
                alpha = jnp.where(active & (pAp != 0),
                                  rz / jnp.where(pAp != 0, pAp, 1.0),
                                  0.0)
                Dx = Dx + alpha[None, :] * P
                R = R - alpha[None, :] * AP
                Z = M_fn(m_args, R)
                rz_new = jnp.sum(R * Z, axis=0)
                beta = jnp.where(active & (rz != 0),
                                 rz_new / jnp.where(rz != 0, rz, 1.0),
                                 0.0)
                P = jnp.where(active[None, :], Z + beta[None, :] * P, P)
                return (i + 1, Dx, R, Z, P, rz_new,
                        cit + active.astype(jnp.int32))

            _, Dx, R, Z, P, rz, cit = jax.lax.while_loop(
                cond, body,
                (jnp.asarray(0, jnp.int32), Dx, R, Z, P, rz, cit0))
            return Dx, R, cit

        # cheap passes: the pass-boundary residual is the inner CG's own
        # final f32 recurrence residual, so NO f64 element apply runs
        # until the certification below
        def cond_cheap(st):
            k, X, R64, rn, tot = st
            return (k < 1 + cheap_passes) & jnp.any(rn > tol)

        def body_cheap(st):
            k, X, R64, rn, tot = st
            Dx, Rf, cit = inner(R64)
            X = X + Dx.astype(jnp.float64)
            R64n = Rf.astype(jnp.float64)
            rn = jnp.sqrt(jnp.sum(R64n * R64n, axis=0))
            return (k + 1, X, R64n, rn, tot + cit.astype(jnp.int64))

        def cond_outer(st):
            k, X, R64, rn, tot = st
            return (k < max_passes) & jnp.any(rn > tol)

        # the f64 residual CARRIES between passes (X is unchanged from
        # the end of pass k to the start of pass k+1, so recomputing it
        # would repeat the previous pass's closing apply): ONE f64
        # element apply per pass plus the opening one.
        def body_outer(st):
            k, X, R64, rn, tot = st
            Dx, _Rf, cit = inner(R64)
            X = X + Dx.astype(jnp.float64)
            R64n = RHS - A_fn(a64, X)
            rn = jnp.sqrt(jnp.sum(R64n * R64n, axis=0))
            return (k + 1, X, R64n, rn, tot + cit.astype(jnp.int64))

        if x0_lift:
            free = a64[3]
            R0 = jnp.where(free[:, None], RHS, 0.0)
        else:
            R0 = RHS - A_fn(a64, X0)
        rn0 = jnp.sqrt(jnp.sum(R0 * R0, axis=0))
        st0 = (jnp.asarray(0, jnp.int32), X0, R0, rn0,
               jnp.zeros(B, dtype=jnp.int64))
        if cheap_passes > 0:
            # ONE leading true pass first: the f32 drift of a pass
            # started at full residual scale is ~2^-24 ||b||, far above
            # tol, so pass 1's boundary must re-base in f64.  From pass
            # 2 on the starting scale is ~1e-4 ||b|| and the carried
            # recurrence residual is trustworthy to ~1e-11 ||b||.
            st0 = jax.lax.cond(jnp.any(rn0 > tol), body_outer,
                               lambda s: s, st0)
            k, X, _R64, _rn, tot = jax.lax.while_loop(
                cond_cheap, body_cheap, st0)
            # certification: the reported norms are ALWAYS a true f64
            # residual, never the carried estimate
            R64 = RHS - A_fn(a64, X)
            rn = jnp.sqrt(jnp.sum(R64 * R64, axis=0))
            st0 = (k, X, R64, rn, tot)
        k, X, R64, rn, tot = jax.lax.while_loop(
            cond_outer, body_outer, st0)
        return X, rn, tot, k

    _REFINE_CACHE[key] = (M_fn, solve)
    return solve


def _refine_program_bicgstab(struct_key, M_fn, n_iters):
    """Nonsymmetric twin of _refine_program (adv-diff sweeps)."""
    key = ("bicgstab", struct_key, id(M_fn), n_iters)
    hit = _REFINE_CACHE.get(key)
    if hit is not None and hit[0] is M_fn:
        return hit[1]
    A_fn, _, _, _ = _operator_program(struct_key)

    @jax.jit
    def refine(a64, a32, m_args, RHS, X, tol, inner_rtol):
        R64 = RHS - A_fn(a64, X)
        rn0 = jnp.sqrt(jnp.sum(R64 * R64, axis=0))
        R = R64.astype(jnp.float32)
        tol_in = jnp.maximum(inner_rtol * rn0,
                             0.1 * tol).astype(jnp.float32)
        Rhat = R
        B = R.shape[1]
        ones = jnp.ones(B, jnp.float32)
        Dx = jnp.zeros_like(R)
        P = jnp.zeros_like(R)
        V = jnp.zeros_like(R)
        it0 = jnp.zeros(B, dtype=jnp.int32)

        def cond(st):
            i, Dx, R, P, V, rho, alpha, omega, cit = st
            rn = jnp.sqrt(jnp.sum(R * R, axis=0))
            return (i < n_iters) & jnp.any(rn > tol_in)

        def body(st):
            i, Dx, R, P, V, rho, alpha, omega, cit = st
            active = jnp.sqrt(jnp.sum(R * R, axis=0)) > tol_in
            rho_new = jnp.sum(Rhat * R, axis=0)
            beta = jnp.where(
                active,
                (rho_new / jnp.where(rho != 0, rho, 1.0))
                * (alpha / jnp.where(omega != 0, omega, 1.0)), 0.0)
            P = jnp.where(active[None, :],
                          R + beta[None, :] * (P - omega[None, :] * V),
                          P)
            Phat = M_fn(m_args, P)
            V = A_fn(a32, Phat)
            denom = jnp.sum(Rhat * V, axis=0)
            alpha = jnp.where(active & (denom != 0),
                              rho_new / jnp.where(denom != 0, denom,
                                                  1.0), 0.0)
            S = R - alpha[None, :] * V
            Shat = M_fn(m_args, S)
            T = A_fn(a32, Shat)
            tt = jnp.sum(T * T, axis=0)
            omega = jnp.where(active & (tt != 0),
                              jnp.sum(T * S, axis=0)
                              / jnp.where(tt != 0, tt, 1.0), 0.0)
            Dx = Dx + alpha[None, :] * Phat + omega[None, :] * Shat
            R = jnp.where(active[None, :], S - omega[None, :] * T, R)
            return (i + 1, Dx, R, P, V, rho_new, alpha, omega,
                    cit + active.astype(jnp.int32))

        st = (jnp.asarray(0, jnp.int32), Dx, R, P, V, ones, ones, ones,
              it0)
        _, Dx, R, P, V, rho, alpha, omega, cit = jax.lax.while_loop(
            cond, body, st)
        X_new = X + Dx.astype(jnp.float64)
        R64n = RHS - A_fn(a64, X_new)
        rn = jnp.sqrt(jnp.sum(R64n * R64n, axis=0))
        return X_new, rn, cit

    _REFINE_CACHE[key] = (M_fn, refine)
    return refine


def solve_sweep(sys: TransportSystem, D_values, mu_values=None,
                robin_matrices=None, rtol=1e-12, maxiter=50000,
                precision=None, chunk_iters=None,
                coarse_mesh=None, u_coarse=None, robin_coarse=None,
                twolevel=None, multilevel=None):
    """Batched transport solve over sweep points.

    D_values: (B,); mu_values: (B,) scalars (ignored if robin_matrices
    given); robin_matrices: (B, F, nd, nd) per-sample Robin assemblies.
    Returns (X (B, ndofs) f64, info dict).

    Batch-minor (n, B) layout + chunked dispatches (solvers/batched.py);
    'mixed' precision runs the bulk in f32 with f64 refinement.
    """
    from ..solvers.batched import batched_bicgstab, batched_cg

    nonsym = sys.Adv is not None
    if precision is None:
        precision = default_precision(nonsym)
    D_vec = jnp.asarray(np.asarray(D_values, dtype=np.float64))
    B = int(D_vec.shape[0])
    if mu_values is None:
        mu_values = np.zeros(B)
    mu_vec = jnp.asarray(np.asarray(mu_values, dtype=np.float64))
    if robin_matrices is None:
        R_batch = None
    else:
        R_batch = jnp.asarray(robin_matrices)
        # pad per-sample Robin matrices to the (bucketed) facet count
        if sys.R is not None and R_batch.shape[1] < sys.R.A64.shape[0]:
            padF = sys.R.A64.shape[0] - R_batch.shape[1]
            R_batch = jnp.concatenate(
                [R_batch, jnp.zeros((B,) + (padF,) + R_batch.shape[2:],
                                    R_batch.dtype)], axis=1)

    if chunk_iters is None:
        # bounded per-dispatch work, quantised to a fixed set so compiled
        # chunk kernels are reused across meshes/batches (each distinct
        # trip count is a fresh compile)
        raw = int(4.0e9 / max(sys.K.A64.shape[0] * 36 * B, 1))
        for cand in (800, 400, 200, 100):
            if raw >= cand:
                chunk_iters = cand
                break
        else:
            chunk_iters = 50

    krylov = batched_bicgstab if nonsym else batched_cg
    free = sys.free

    import os as _os0
    use_fused = _os0.environ.get("FEU_FUSED", "0") == "1"
    if use_fused:
        # fuse coefficients into ONE element array (one scatter per
        # iteration).  Opt-in; the separate-blocks path is the default.
        fused = _build_fused(sys, D_vec, mu_vec, R_batch)
        dofs_f, perm_f, ids_f, ndofs_f = (fused.dofs, fused.perm,
                                          fused.ids_sorted, fused.ndofs)

        def _fused_apply(Aarr, X):
            return _fused_apply_impl(Aarr, dofs_f, perm_f, ids_f,
                                     ndofs_f, X)

        def _A_bc_fn(a_args, X):
            (Aarr,) = a_args
            Y = _fused_apply(Aarr, jnp.where(free[:, None], X, 0.0))
            return jnp.where(free[:, None], Y, X)

        A64 = (_A_bc_fn, (fused.A64,))
        A32 = (_A_bc_fn, (fused.A32,))
        _, _, diag = _batched_operator(sys, D_vec, mu_vec, R_batch,
                                       f32=False)
        dinv = jnp.where(free[:, None] & (diag != 0),
                         1.0 / jnp.where(diag != 0, diag, 1.0), 1.0)
        G = jnp.tile(sys.bc_values[:, None], (1, B))
        RHS = jax.jit(lambda Aarr, G_: jnp.where(
            free[:, None], -_fused_apply(Aarr, G_), G_))(fused.A64, G)
        res_fn_args = (fused.A64,)
        res_A_fn = _A_bc_fn
        residual_fn = jax.jit(lambda a, RHS_, X_: (
            lambda Rr: (Rr, jnp.linalg.norm(Rr, axis=0)))(
                RHS_ - res_A_fn(a, X_)))
    else:
        # stable cached programs: element arrays + coefficients are
        # runtime ARGUMENTS, so a new mu batch or a new same-bucket mesh
        # reuses every compiled chunk (round-2 fix: the closure-constant
        # form re-traced + re-compiled per call)
        A_fn, rhs_fn, residual_fn, diag_fn = _operator_program(
            sys_struct_key(sys))
        a64 = operator_args(sys, D_vec, mu_vec, R_batch, f32=False)
        a32 = operator_args(sys, D_vec, mu_vec, R_batch, f32=True)
        A64 = (A_fn, a64)
        A32 = (A_fn, a32)
        G = jnp.tile(sys.bc_values[:, None], (1, B))
        RHS = rhs_fn(a64, G)
        dinv = diag_fn(a64)
        res_fn_args = a64
    X0 = G  # exact on constrained dofs from the start

    import os as _os
    import time as _time
    _dbg = _os.environ.get("FEU_TIMING") == "1"

    def _t(msg, t0):
        if _dbg:
            print(f"[sweep] {msg}: {_time.time() - t0:.1f}s", flush=True)
        return _time.time()

    _tt = _time.time()
    # optional two-level (coarse-grid) preconditioner
    tl = twolevel
    if tl is None and coarse_mesh is not None:
        from ..solvers.twolevel import build_twolevel
        tl = build_twolevel(sys, coarse_mesh, np.asarray(D_values),
                            mu_values=np.asarray(mu_values),
                            robin_matrices_coarse=robin_coarse,
                            u_coarse=u_coarse)
    _tt = _t("twolevel build", _tt)

    def make_M(f32):
        if multilevel is not None:
            from ..solvers.multilevel import make_ml_preconditioner
            return make_ml_preconditioner(multilevel, f32=f32)
        dv = dinv.astype(jnp.float32) if f32 else dinv
        if tl is None:
            return (_jacobi_M, (dv,))
        from ..solvers.twolevel import make_preconditioner
        return make_preconditioner(tl, dinv, f32=f32)

    if precision == "f64":
        res = krylov(A64, RHS, X0=X0, M=make_M(False), rtol=rtol,
                     maxiter=maxiter, chunk_iters=chunk_iters)
        X = res.X
        iters, resnorm = res.iters, res.resnorm
    elif precision == "f32":
        res = krylov(A32, RHS.astype(jnp.float32),
                     X0=X0.astype(jnp.float32),
                     M=make_M(True), rtol=max(rtol, 1e-6),
                     maxiter=maxiter, chunk_iters=chunk_iters)
        X = res.X.astype(jnp.float64)
        iters, resnorm = res.iters, res.resnorm
    else:  # mixed: f32 inner + f64 refinement
        M32 = make_M(True)
        bnorm = np.asarray(jnp.linalg.norm(RHS, axis=0))
        tol = rtol * bnorm
        X = X0
        total_iters = np.zeros(B, dtype=np.int64)
        resnorm = bnorm.copy()
        n_passes = 0
        if not use_fused and not nonsym:
            # ONE device dispatch per refinement pass (f64 residual +
            # early-exit f32 CG + f64 update + residual norms fused), or
            # the whole pass loop as one program (_mixed_solve_program).
            import os as _os2
            M32_fn, m32_args = M32
            # inner f32 residual-reduction target per refinement pass.
            # Measured at h=0.02/B=20: 1e-6 does NOT shrink the pass
            # count (the f32 recurrence floor forces a third confirming
            # pass anyway) and costs ~4 extra iterations -- 1e-4 in
            # three shallow passes is the optimum.
            inner_rtol = float(_os2.environ.get("FEU_INNER_RTOL",
                                                "1e-4"))
            if _os2.environ.get("FEU_FUSED_SOLVE", "0") == "1":
                solve_prog = _mixed_solve_program(
                    sys_struct_key(sys), M32_fn,
                    n_iters=min(300, maxiter),
                    # X here is always the Dirichlet lift G (zero on
                    # free dofs, fem/assembly.py BCData), so the
                    # opening f64 residual is where(free, RHS, 0)
                    x0_lift=True)
                X, rn_dev, tot, passes = solve_prog(
                    a64, a32, m32_args, RHS, X, jnp.asarray(tol),
                    inner_rtol)
                resnorm = np.asarray(rn_dev)
                total_iters = np.asarray(tot, dtype=np.int64)
                n_passes = int(np.asarray(passes))
            else:
                refine = _refine_program(sys_struct_key(sys), M32_fn,
                                         n_iters=min(300, maxiter))
                tol_dev = jnp.asarray(tol)
                for _ref in range(12):
                    X, rn_dev, cit = refine(a64, a32, m32_args, RHS, X,
                                            tol_dev, inner_rtol)
                    resnorm = np.asarray(rn_dev)
                    total_iters += np.asarray(cit, dtype=np.int64)
                    n_passes = _ref + 1
                    _tt = _t(f"refine {_ref}: "
                             f"({int(np.asarray(cit).max())} iters)", _tt)
                    if (resnorm <= tol).all():
                        break
        elif not use_fused and nonsym:
            # ONE device dispatch per refinement pass (f64 residual +
            # early-exit f32 BiCGStab + f64 update + residual norms)
            M32_fn, m32_args = M32
            refine = _refine_program_bicgstab(sys_struct_key(sys),
                                              M32_fn,
                                              n_iters=min(300, maxiter))
            tol_dev = jnp.asarray(tol)
            for _ref in range(12):
                X, rn_dev, cit = refine(a64, a32, m32_args, RHS, X,
                                        tol_dev, 1e-4)
                resnorm = np.asarray(rn_dev)
                total_iters += np.asarray(cit, dtype=np.int64)
                n_passes = _ref + 1
                _tt = _t(f"refine {_ref}: pass "
                         f"({int(np.asarray(cit).max())} iters, max rel "
                         f"{(resnorm / np.maximum(bnorm, 1e-300)).max():.2e})",
                         _tt)
                if (resnorm <= tol).all():
                    break
        else:
            # residual_fn is jitted and stable across calls (set above)
            for _ref in range(12):
                Rres, rn_dev = residual_fn(res_fn_args, RHS, X)
                resnorm = np.asarray(rn_dev)
                _tt = _t(f"refine {_ref}: f64 residual "
                         f"(max {resnorm.max():.2e})", _tt)
                if (resnorm <= tol).all():
                    break
                res = krylov(A32, Rres.astype(jnp.float32),
                             M=M32, rtol=1e-4,
                             maxiter=maxiter, chunk_iters=chunk_iters)
                _tt = _t(f"refine {_ref}: f32 inner "
                         f"({int(res.iters.max())} iters)", _tt)
                X = X + res.X.astype(jnp.float64)
                total_iters += res.iters
        iters = total_iters
    # strip padding dofs + undo the band (RCM) renumbering
    bnorm_out = np.asarray(jnp.linalg.norm(RHS, axis=0))
    rel = np.asarray(resnorm) / np.where(bnorm_out > 0, bnorm_out, 1.0)
    info = {"iters": np.asarray(iters), "resnorm": np.asarray(resnorm),
            "rel_resnorm": rel}
    if precision not in ("f64", "f32"):
        info["passes"] = n_passes   # outer f64 defect-correction passes
    return (unpermute_columns(sys, jnp.moveaxis(X, 0, 1)), info)


# ---------------------------------------------------------------------------
# legacy simple-mu API (pure diffusion, D fixed) kept for tests/entry points
# ---------------------------------------------------------------------------

MuSweepSystem = TransportSystem


_MU_D: Dict[int, float] = {}


def build_mu_sweep_system(mesh: MeshData, D=1.0, element="P2",
                          u_values=None, u_space=None) -> TransportSystem:
    sys = build_transport_system(mesh, element=element, u_values=u_values,
                                 u_space=u_space, robin_degree=4)
    # record the fixed D for solve_mu_sweep (sweep varies mu only)
    _MU_D[id(sys)] = float(D)
    return sys


def solve_mu_sweep(sys: TransportSystem, mu_values, rtol=1e-13,
                   maxiter=50000, precision=None):
    D = _MU_D.get(id(sys), 1.0)
    B = len(mu_values)
    return solve_sweep(sys, [D] * B, mu_values=mu_values, rtol=rtol,
                       maxiter=maxiter, precision=precision)


def _solve_single(sys: TransportSystem, mu, rtol, maxiter):
    """Single-mu solve (used by __graft_entry__)."""
    solve_one = _solve_one_factory(sys, rtol, maxiter, "f64")
    D = _MU_D.get(id(sys), 1.0)
    x, iters, resnorm = solve_one(jnp.asarray(D, dtype=jnp.float64),
                                  mu, None)
    x = unpermute_columns(sys, x[None, :])[0]
    return x, iters, resnorm
