"""Batched geometric multigrid V-cycle preconditioner.

Round-1's two-level preconditioner (solvers/twolevel.py) cut Jacobi-CG's
O(1/h) iteration growth ~10x, but its dense per-sample coarse inverses
dominated the sweep setup (20 x (nc=1850)^2 f32 = 274 MB upload + 46 s
host factorisation at the study mesh h=0.02).  This module replaces it
with a geometric multigrid hierarchy:

    fine (P2, h)  ->  mid (P1, ~3h)  ->  coarsest (P1, ~9h, DENSE)

  - every level's operator is the SAME batched element machinery as the
    fine sweep (A_l(D,mu) = D*K_l + Adv_l + mu*R_l, batch-minor (n_l, B)):
    coefficients stay factored out, so setup is coefficient-independent
    except for the tiny coarsest inverses (~400 dofs -> ~13 MB for B=20);
  - transfers are barycentric interpolation between independently
    generated meshes of the same geometry (non-nested rediscretised MG),
    restriction = P^T as a sorted segment-sum scatter;
  - the V(1,1) cycle uses weighted-Jacobi smoothing; pre-smooth from zero
    + mirrored post-smooth makes M symmetric positive definite for omega
    below 2/lambda_max(D^-1 A), so plain CG applies.

The whole cycle is (n, B)-batched: one V-cycle preconditions all sweep
columns at once, and the only mu-dependent setup is a stack of small
dense inverses.

Replaces: PETSc LU (ref solvers.py:55,151) as the scalable solve path;
see SURVEY.md section 7.1 item 4.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MultilevelData", "build_multilevel", "make_ml_preconditioner",
           "coarse_level_meshes", "level_meshes_for",
           "build_multilevel_for"]


class _Transfer(NamedTuple):
    cols: jnp.ndarray         # (n_fine, 3) coarse vertex ids
    weights: jnp.ndarray      # (n_fine, 3) barycentric weights (f32)
    perm: jnp.ndarray         # scatter plan for P^T
    ids_sorted: jnp.ndarray
    n_coarse: int


class _RectBand(NamedTuple):
    """Device arrays of one windowed-band transfer direction."""
    band: jnp.ndarray         # (T, R, W) f32
    offs: jnp.ndarray         # (T,) int32 window starts


class _Level(NamedTuple):
    sys: "object"             # TransportSystem (parallel/sweep.py)
    dinv: jnp.ndarray         # (n_l, B) f32 inverse diagonal (free dofs)
    free: jnp.ndarray         # (n_l,) bool
    transfer: Optional[_Transfer]   # to next coarser level (None = coarsest)
    # windowed-band transfer form (ops/banded.py RectBandPlan): the
    # V-cycle's restrict/prolong as per-tile dense matmuls instead of the
    # gather + sorted-segment-sum pair.  (band_p, plan_p, band_r, plan_r)
    # or None (gather path).
    bands: Optional[tuple] = None


class MultilevelData(NamedTuple):
    levels: tuple             # tuple of _Level, fine -> coarse
    Ainv: jnp.ndarray         # (B, nc, nc) f32 coarsest dense inverses
    free_c: jnp.ndarray       # (nc,) bool coarsest free mask
    omega: float
    D_vec: jnp.ndarray
    mu_vec: jnp.ndarray
    R_batches: tuple          # per-level per-sample Robin (fine first),
                              # None entries = scalar mu_vec scaling


def coarse_level_meshes(mesh_kwargs, mesh_size, factors=(3.0, 9.0),
                        generate=None):
    """Generate the coarser-level meshes of the same geometry.

    mesh_kwargs: the generate_mesh kwargs minus mesh_size.
    Returns a list of MeshData, one per factor (ordered fine->coarse).
    """
    if generate is None:
        from ..meshing.generator import generate_mesh as generate
    out = []
    for f in factors:
        out.append(generate(mesh_size=mesh_size * f, **mesh_kwargs))
    return out


_LEVEL_MESH_CACHE = {}


def level_meshes_for(mesh, factors=(3.0, 9.0), cap=0.45, nested=None):
    """Coarser-level meshes of the same geometry as ``mesh`` (cached).

    Reads the generation parameters off mesh.geom; level h is capped so
    the coarsest mesh stays valid relative to the channel height.

    nested (default on, FEU_ML_NESTED=0 disables): the first level is
    the fine mesh ITSELF -- a P1 space nested inside the fine P2 space
    with exact embedding transfers.  The P2 fine level's Jacobi
    smoothing is weak (P2 stencils smooth poorly pointwise) and the
    non-nested barycentric P2->P1(3h) jump was the MG bottleneck:
    inserting the nested level cuts CG iterations 61 -> 24 on the bench
    workload for one extra (cheap, half-the-rows P1) level.
    """
    import os as _os
    from ..meshing.generator import generate_mesh
    g = mesh.geom
    if nested is None:
        nested = _os.environ.get("FEU_ML_NESTED", "1") == "1"
    out = [mesh] if nested else []
    for f in factors:
        h_l = min(g.mesh_size * float(f), cap * g.height)
        key = (mesh.domain_type, g.width, g.height, g.sulcus_depth,
               g.sulcus_width, h_l)
        if key not in _LEVEL_MESH_CACHE:
            _LEVEL_MESH_CACHE[key] = generate_mesh(
                width=g.width, height=g.height,
                sulcus_depth=g.sulcus_depth, sulcus_width=g.sulcus_width,
                mesh_size=h_l, refinement_factor=1,
                domain_type=mesh.domain_type)
        out.append(_LEVEL_MESH_CACHE[key])
    return out


CACHE_STATS = {"hits": 0, "misses": 0}
_INTERP_MEMO: dict = {}


def _interp(fine_coords, coarse_mesh, free_fine, n_fine_out=None,
            n_coarse_out=None, coarse_old2new=None, hint_cells=None):
    """Barycentric transfer data (host). Same scheme as twolevel.py.

    hint_cells: per-fine-point owning cell in coarse_mesh (the nested
    same-mesh level, where every P2 dof's cell is known from the
    dofmap) -- skips the KD-tree point-location pass entirely and the
    barycentric coordinates come from one batched affine inverse
    (~20-40 s -> ms per geometry at study size).

    n_fine_out / n_coarse_out: padded (shape-bucketed) sizes -- padding
    rows get zero weights, the restriction output is simply sized to the
    padded coarse dof count (padding dofs are constrained there).
    coarse_old2new: when the coarse system is RCM-renumbered (banded
    operator form), maps mesh-vertex dof ids into its numbering.

    The point-location output is pure in its inputs and costs ~1-2 s of
    host work per level at study size, so it is persisted across
    processes (utils/diskcache.py, FFC-cache style)."""
    from ..utils.diskcache import cache_key_of, cached_arrays

    fine_coords = np.asarray(fine_coords)
    free_np = np.asarray(free_fine)
    o2n = None if coarse_old2new is None else np.asarray(coarse_old2new)
    key = cache_key_of(fine_coords, coarse_mesh.vertices,
                       coarse_mesh.cells, free_np, n_fine_out,
                       n_coarse_out, o2n)

    def _build():
        from ..analysis.profiles import PointLocator
        from scipy.spatial import cKDTree
        if hint_cells is not None:
            cells = np.asarray(hint_cells)
            tri = coarse_mesh.cells[cells]
            v = coarse_mesh.vertices
            a = v[tri[:, 0]]
            e1 = v[tri[:, 1]] - a
            e2 = v[tri[:, 2]] - a
            rhs = fine_coords - a
            det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
            det = np.where(det == 0, 1.0, det)
            x = (e2[:, 1] * rhs[:, 0] - e2[:, 0] * rhs[:, 1]) / det
            y = (-e1[:, 1] * rhs[:, 0] + e1[:, 0] * rhs[:, 1]) / det
            ref = np.stack([x, y], axis=1)
        else:
            loc = PointLocator(coarse_mesh, k=12, tol=1e-8)
            cells, ref = loc.locate(fine_coords)
        bad = cells < 0
        lam = np.concatenate([1 - ref.sum(1, keepdims=True), ref], axis=1)
        lam = np.clip(lam, 0.0, 1.0)
        lam /= np.maximum(lam.sum(1, keepdims=True), 1e-300)
        cols = coarse_mesh.cells[np.where(bad, 0, cells)]
        if bad.any():
            tree = cKDTree(coarse_mesh.vertices)
            _, nearest = tree.query(fine_coords[bad], workers=-1)
            cols[bad] = np.stack([nearest] * 3, axis=1)
            lam[bad] = np.array([1.0, 0.0, 0.0])
        nf = len(fine_coords)
        lam[~free_np[:nf]] = 0.0
        if n_fine_out is not None and n_fine_out > nf:
            cols = np.concatenate(
                [cols, np.zeros((n_fine_out - nf, 3), cols.dtype)])
            lam = np.concatenate(
                [lam, np.zeros((n_fine_out - nf, 3))])
        if o2n is not None:
            cols = o2n[cols]
        ids = cols.ravel()
        perm = np.argsort(ids, kind="stable")
        return {"cols": cols.astype(np.int32),
                "lam": lam.astype(np.float32),
                "perm": perm.astype(np.int32),
                "ids_sorted": ids[perm].astype(np.int32)}

    memo = _INTERP_MEMO.get(key)
    if memo is not None:
        CACHE_STATS["hits"] += 1
        return memo
    data, hit = cached_arrays("mltransfer", key, _build)
    CACHE_STATS["hits" if hit else "misses"] += 1
    n_coarse = (len(coarse_mesh.vertices) if n_coarse_out is None
                else int(n_coarse_out))
    # host numpy leaves: the caller ships all transfers together with
    # the level systems in one device_put (_ship_to_default_device)
    out = _Transfer(
        cols=np.asarray(data["cols"], dtype=np.int32),
        weights=np.asarray(data["lam"], dtype=np.float32),
        perm=np.asarray(data["perm"], dtype=np.int32),
        ids_sorted=np.asarray(data["ids_sorted"], dtype=np.int32),
        n_coarse=n_coarse)
    _INTERP_MEMO[key] = out
    while len(_INTERP_MEMO) > 12:      # ~5-15 MB per fine-level entry
        _INTERP_MEMO.pop(next(iter(_INTERP_MEMO)))
    return out


def _ship_to_default_device(tree):
    """Ship every non-float64 array leaf of a nested structure
    (NamedTuples / lists / tuples / arrays / None) to the default
    device, uncommitted.

    ALL leaves go through ONE jax.device_put call: the full MG payload
    (level systems + transfers + diagonals + Robin batches) is ~50 small
    arrays.

    float64 leaves (A64 element arrays, dof_coords, quadrature data) are
    NOT shipped: the accelerator V-cycle consumes only the f32/bf16
    views + int/bool structure.  They stay as host numpy arrays inside
    the returned structure; any device use auto-transfers."""
    leaves = []

    def collect(nt):
        if hasattr(nt, "_fields"):
            return [collect(getattr(nt, f)) for f in nt._fields]
        if isinstance(nt, (list, tuple)):
            return [collect(x) for x in nt]
        if isinstance(nt, (jnp.ndarray, np.ndarray)):
            arr = np.asarray(nt)
            if arr.dtype == np.float64:
                return arr
            leaves.append(arr)
            return len(leaves) - 1
        return nt

    struct = collect(tree)
    shipped = jax.device_put(leaves) if leaves else []

    def rebuild(nt, tmpl):
        if hasattr(tmpl, "_fields"):
            return type(tmpl)(*[rebuild(s, getattr(tmpl, f))
                                for s, f in zip(nt, tmpl._fields)])
        if isinstance(tmpl, (list, tuple)):
            return type(tmpl)(rebuild(s, x) for s, x in zip(nt, tmpl))
        if isinstance(nt, int) and isinstance(tmpl,
                                              (jnp.ndarray, np.ndarray)):
            return shipped[nt]
        return nt

    return rebuild(struct, tree)


def _dinv_of(diag, free):
    return jnp.where(free[:, None] & (diag != 0),
                     1.0 / jnp.where(diag != 0, diag, 1.0),
                     1.0).astype(jnp.float32)


def _level_dinv_np(sys_l, D_vec, mu_vec, R_batch):
    """Pure-numpy (n_l, B) f32 inverse diagonal for a (host) mid level.

    Equivalent to _level_diag + _dinv_of but with zero jax dispatches:
    the mid levels are tiny and this runs once per setup, where eager
    CPU dispatch/compile-cache latency (~0.5 s/process) dominated."""
    def seg_diag(b, Ae):
        de = np.diagonal(np.asarray(Ae), axis1=-2, axis2=-1)
        if de.ndim == 3:                       # (B, N, nd) per-sample
            de = np.moveaxis(de.reshape(de.shape[0], -1), 0, 1)
        else:
            de = de.reshape(-1)
        de = de[np.asarray(b.perm)]
        out = np.zeros((b.ndofs,) + de.shape[1:])
        np.add.at(out, np.asarray(b.ids_sorted), de)
        return out

    D = np.asarray(D_vec)
    mu = np.asarray(mu_vec)
    d = D[None, :] * seg_diag(sys_l.K, sys_l.K.A64)[:, None]
    if sys_l.Adv is not None:
        d = d + seg_diag(sys_l.Adv, sys_l.Adv.A64)[:, None]
    if sys_l.R is not None:
        if R_batch is None:
            d = d + mu[None, :] * seg_diag(sys_l.R, sys_l.R.A64)[:, None]
        else:
            d = d + seg_diag(sys_l.R, R_batch)
    free = np.asarray(sys_l.free)
    ok = free[:, None] & (d != 0)
    return np.where(ok, 1.0 / np.where(d != 0, d, 1.0),
                    1.0).astype(np.float32)


# structure-keyed jitted dinv: the eager diagonal()/where chain costs
# ~10 dispatches at the fine level; this folds it into one compiled call
# with arrays as arguments
_DINV_PROG_CACHE = {}


def _fine_dinv(sys_l, D_vec, mu_vec, R_batch):
    """One-dispatch (n, B) f32 inverse diagonal of the fine operator."""
    key = (sys_l.ndofs, sys_l.K.A64.shape[0],
           None if sys_l.Adv is None else sys_l.Adv.A64.shape[0],
           None if sys_l.R is None else sys_l.R.A64.shape[0],
           None if R_batch is None else tuple(R_batch.shape))
    prog = _DINV_PROG_CACHE.get(key)
    if prog is None:
        ndofs = sys_l.ndofs

        def diag_of(A, perm, ids):
            de = jnp.diagonal(A, axis1=1, axis2=2)
            return jax.ops.segment_sum(
                de.reshape(-1)[perm], ids, num_segments=ndofs,
                indices_are_sorted=True)

        def f(K, Adv, R, Rb, free, D_vec, mu_vec):
            d = D_vec[None, :] * diag_of(*K)[:, None]
            if Adv is not None:
                d = d + diag_of(*Adv)[:, None]
            if R is not None:
                if Rb is None:
                    d = d + mu_vec[None, :] * diag_of(*R)[:, None]
                else:
                    de = jnp.diagonal(Rb, axis1=2, axis2=3)
                    B = de.shape[0]
                    de = jnp.moveaxis(de.reshape(B, -1), 0, 1)
                    d = d + jax.ops.segment_sum(
                        de[R[1]], R[2], num_segments=ndofs,
                        indices_are_sorted=True)
            return _dinv_of(d, free)

        prog = jax.jit(f)
        _DINV_PROG_CACHE[key] = prog

    def args_of(b):
        return None if b is None else (b.A64, b.perm, b.ids_sorted)

    return prog(args_of(sys_l.K), args_of(sys_l.Adv), args_of(sys_l.R),
                R_batch, sys_l.free, D_vec, mu_vec)


def build_multilevel(sys, level_meshes, D_values, mu_values=None,
                     robin_matrices_levels=None, robin_matrices_fine=None,
                     u_levels=None, omega=0.65,
                     dirichlet=None, with_robin=True):
    """Build the MG hierarchy for a TransportSystem sweep.

    sys: fine TransportSystem; level_meshes: MeshData list fine->coarse
    (the last one is solved densely).  D_values/mu_values: (B,) sweep
    coefficients.  robin_matrices_levels: optional per-level (B,F,nd,nd)
    per-sample Robin element matrices (step-mu sweeps); list aligned with
    level_meshes.  robin_matrices_fine: the fine system's per-sample
    Robin matrices (step-mu), used for fine-level smoothing.  u_levels:
    optional list of (values, space) velocity per level mesh (advective
    systems).
    """
    from ..parallel.sweep import build_transport_system

    import os as _os
    import time as _time
    _dbg = _os.environ.get("FEU_TIMING") == "1"
    _t = [_time.time()]

    def _tick(stage):
        if _dbg:
            now = _time.time()
            print(f"    [ml-setup] {stage}: {now - _t[0]:.2f}s",
                  flush=True)
            _t[0] = now

    D_vec = jnp.asarray(np.asarray(D_values, dtype=np.float64))
    B = int(D_vec.shape[0])
    mu_vec = (jnp.zeros(B) if mu_values is None
              else jnp.asarray(np.asarray(mu_values, dtype=np.float64)))

    n_levels = len(level_meshes)
    R_batches = ([None] * n_levels if robin_matrices_levels is None
                 else list(robin_matrices_levels))

    # per-level systems (P1: these are small).  On an accelerator they
    # are assembled on the host CPU backend -- ~15 tiny eager assembly
    # dispatches and per-geometry level shapes stay off the device -- and
    # the arrays ship to the device in one put (below).
    # The BC/Robin structure mirrors the fine system's (transport
    # default, or e.g. the Stokes velocity Laplacian's wall-Dirichlet).
    cpu0 = None
    try:
        cpu0 = jax.devices("cpu")[0]
    except Exception:
        pass
    # shape-bucket the level systems whenever the fine system is padded:
    # unpadded level shapes would re-trace + recompile the whole
    # V-cycle program per geometry in multi-mesh studies.  Buckets are
    # sized BY LEVEL SIZE, coarse enough that the study's 23 geometries
    # share them: the nested fine-mesh P1 level uses the fine system's
    # granularity, mids a 2048-dof grid, and the coarsest a 512-dof grid
    # (its dense inverse scales with nc^2; measured: 1024-dof granular
    # level buckets made EVERY geometry a fresh ~300 s refine-program
    # compile in the Phase-B study).
    pad_levels = sys.ndofs > len(sys.space.dof_coords)

    def _gran_for(m):
        if m.num_cells > 20000:
            return (8192, 4096, 512)
        if m.num_cells > 1500:
            return (2048, 8192, 512)
        return (512, 2048, 256)

    level_gran = [_gran_for(m) for m in level_meshes]
    lsys = []
    import contextlib
    ctx = (jax.default_device(cpu0) if cpu0 is not None
           and jax.default_backend() != "cpu" else contextlib.nullcontext())
    with ctx:
        for i, m in enumerate(level_meshes):
            kw = {}
            if u_levels is not None and u_levels[i] is not None:
                kw = dict(u_values=u_levels[i][0], u_space=u_levels[i][1])
            lsys.append(build_transport_system(
                m, element="P1", pad_shapes=pad_levels,
                pad_granularity=level_gran[i], dirichlet=dirichlet,
                with_robin=with_robin, disk_cache=True, **kw))
    _tick('level systems (host, cached)')

    def _pad_Rb(Rb, blk):
        """Pad per-sample Robin matrices to a block's padded facet count
        (kept as host numpy until consumed)."""
        if Rb is None or blk is None:
            return Rb
        Rb = np.asarray(Rb)
        padF = blk.A64.shape[0] - Rb.shape[1]
        if padF > 0:
            Rb = np.concatenate(
                [Rb, np.zeros((Rb.shape[0], padF) + Rb.shape[2:],
                              Rb.dtype)], axis=1)
        return Rb

    R_batches = [_pad_Rb(R_batches[i], lsys[i].R)
                 for i in range(n_levels)]
    robin_matrices_fine = _pad_Rb(robin_matrices_fine, sys.R)

    _tick('pad Robin')
    # mid-level inverse diagonals: computed on the CPU copies BEFORE
    # shipping (each _level_diag is ~10 eager dispatches; in numpy on
    # the host they are milliseconds)
    mid_dinv = []
    for i in range(n_levels - 1):
        mid_dinv.append(_level_dinv_np(lsys[i], D_vec, mu_vec,
                                       R_batches[i]))
    _tick('mid diagonals (host numpy)')
    lsys_cpu = lsys

    # transfers: fine(sys) -> mesh0, mesh0 -> mesh1, ... (all at padded
    # sizes so the compiled V-cycle is geometry-independent per bucket).
    # Rows follow each level's own (possibly RCM-renumbered) dof order;
    # columns are mapped into the next level's numbering.  Built from
    # the HOST level systems (numpy leaves, disk-cached).
    def _coords_of(s, mesh_vertices=None):
        c = (np.asarray(s.space.dof_coords) if mesh_vertices is None
             else np.asarray(mesh_vertices))
        if s.perm is not None:
            c = c[np.asarray(s.perm)[:len(c)]]
        return c

    transfers = []
    free_fine = np.asarray(sys.free)
    hint0 = None
    if level_meshes[0] is sys.space.mesh:
        # nested same-mesh level: every fine dof's owning cell is known
        # from the dofmap -- exact location, no KD-tree pass
        cd = np.asarray(sys.space.scalar_dofmap.cell_dofs)
        hint0 = np.zeros(sys.space.ndofs_scalar, dtype=np.int64)
        hint0[cd.ravel()] = np.repeat(np.arange(len(cd)), cd.shape[1])
        if sys.perm is not None:
            hint0 = hint0[np.asarray(sys.perm)[:len(hint0)]]
    transfers.append(_interp(_coords_of(sys), level_meshes[0],
                             free_fine, n_fine_out=sys.ndofs,
                             n_coarse_out=lsys[0].ndofs,
                             coarse_old2new=lsys[0].iperm,
                             hint_cells=hint0))
    for i in range(n_levels - 1):
        transfers.append(_interp(
            _coords_of(lsys[i], level_meshes[i].vertices),
            level_meshes[i + 1],
            np.asarray(lsys[i].free),
            n_fine_out=lsys[i].ndofs,
            n_coarse_out=lsys[i + 1].ndofs,
            coarse_old2new=lsys[i + 1].iperm))
    _tick('transfers (host, cached)')

    # windowed-band transfer PLANS (host numpy; ops/banded.py): the
    # V-cycle's restrict/prolong become per-tile dense matmuls.  Values
    # are scattered on DEVICE after shipping, so only the int32 id
    # vectors are uploaded, never the O(100 MB) bands themselves.
    tband_plans = None
    tband_devkey = None
    if _ml_tband():
        n_fine_l = [sys.ndofs] + [s.ndofs for s in lsys[:-1]]
        n_coarse_l2 = [s.ndofs for s in lsys]
        keyed = [
            _aligned_plans_cached(np.asarray(tr.cols),
                                  np.asarray(tr.weights),
                                  int(n_fine_l[l]),
                                  int(n_coarse_l2[l]))
            for l, tr in enumerate(transfers)]
        tband_devkey = tuple(k for k, _ in keyed)
        tband_plans = [p for _, p in keyed]
        _tick('transfer band plans (host, cached)')

    # the V-cycle consumes Robin batches in f32 (smoothing dtype), so
    # ship f32 copies; the host f64 originals stay for the CPU coarse
    # path.  ONE device_put ships the whole MG payload.
    Rb_f32 = [None if rb is None else np.asarray(rb, dtype=np.float32)
              for rb in R_batches]
    rbf_f32 = (None if robin_matrices_fine is None
               else np.asarray(robin_matrices_fine, dtype=np.float32))
    mid_dinv_d = mid_dinv
    if cpu0 is not None and jax.default_backend() != "cpu":
        # With banded applies in M (_ml_band_in_M) the level bands are
        # V-cycle hot-path arrays: ship them with the payload.  Otherwise they stay
        # HOST-side -- the element-path V-cycle never reads them and the
        # mid-level band is ~85% of the payload bytes (12.6 MB at
        # h=0.06).
        ship_bands = _ml_band_in_M()
        bands = [(s.Kband, s.Advband) for s in lsys]
        if not ship_bands:
            lsys = [s._replace(Kband=None, Advband=None) for s in lsys]
        # identity-pinned ship memo: the level systems and transfers are
        # content-memoised upstream (_TSYS_MEMO / _INTERP_MEMO), so a
        # warm same-geometry rebuild presents the SAME host objects --
        # reuse the device copies instead of re-uploading the payload.  mid_dinv/Rb depend only on those plus the
        # (D, mu) coefficients, which join the key by content.
        ship_key = (tuple(id(s) for s in lsys),
                    tuple(id(t) for t in transfers),
                    np.asarray(D_vec).tobytes(),
                    np.asarray(mu_vec).tobytes(),
                    tuple(id(r) for r in Rb_f32),
                    None if rbf_f32 is None else id(rbf_f32),
                    ship_bands)
        hit = _SHIP_MEMO.get(ship_key)
        if hit is not None and hit[0] == ship_key:
            lsys, transfers, mid_dinv_d, rbf_f32, Rb_f32 = hit[2]
        else:
            pins = (list(lsys), list(transfers), list(Rb_f32), rbf_f32)
            lsys, transfers, mid_dinv_d, rbf_f32, Rb_f32 = (
                _ship_to_default_device(
                    (lsys, transfers, mid_dinv_d, rbf_f32, Rb_f32)))
            # pins keep the keyed host objects alive so ids stay valid
            _SHIP_MEMO[ship_key] = (ship_key, pins,
                                    (lsys, transfers, mid_dinv_d,
                                     rbf_f32, Rb_f32))
            while len(_SHIP_MEMO) > 3:
                _SHIP_MEMO.pop(next(iter(_SHIP_MEMO)))
        if not ship_bands:
            lsys = [s._replace(
                Kband=None if kb is None else np.asarray(kb),
                Advband=None if ab is None else np.asarray(ab))
                for s, (kb, ab) in zip(lsys, bands)]
    _tick('ship MG payload to device (one put)')

    # levels: fine + all mids (the coarsest is the dense solve, no smooth)
    levels = []
    fine_dinv = _fine_dinv(sys, D_vec, mu_vec, rbf_f32)
    levels.append(_Level(sys=sys, dinv=fine_dinv, free=sys.free,
                         transfer=transfers[0]))
    for i in range(n_levels - 1):
        levels.append(_Level(sys=lsys[i], dinv=jnp.asarray(mid_dinv_d[i]),
                             free=lsys[i].free,
                             transfer=transfers[i + 1]))

    if tband_plans is not None:
        hit = _TBAND_DEV_CACHE.get(tband_devkey)
        if hit is not None:
            # same geometry rebuilt in-process (warm study/bench reps):
            # the bands are pure in the transfer content -- reuse the
            # device arrays, skip uploads and the scatter dispatch
            for l, btup in hit:
                levels[l] = levels[l]._replace(bands=btup)
        else:
            # scatter transfer weights into the windowed bands ON
            # DEVICE
            live_l = [l for l in range(len(levels))
                      if tband_plans[l] is not None]
            flat_plans = []
            vals = []
            for l in live_l:
                p_p, p_r, _, _ = tband_plans[l]
                w_dev = levels[l].transfer.weights
                flat_plans += [p_p, p_r]
                vals += [w_dev, w_dev]
            bands = _tband_values_all(flat_plans, vals)
            entry = []
            for j, l in enumerate(live_l):
                p_p, p_r, sig, isig = tband_plans[l]
                btup = (
                    _RectBand(band=bands[2 * j],
                              offs=jnp.asarray(p_p.offs)),
                    p_p,
                    _RectBand(band=bands[2 * j + 1],
                              offs=jnp.asarray(p_r.offs)),
                    p_r,
                    jnp.asarray(sig), jnp.asarray(isig))
                levels[l] = levels[l]._replace(bands=btup)
                entry.append((l, btup))
            _TBAND_DEV_CACHE[tband_devkey] = entry
            while len(_TBAND_DEV_CACHE) > 2:   # ~400 MB HBM per entry
                _TBAND_DEV_CACHE.pop(next(iter(_TBAND_DEV_CACHE)))
        _tick('transfer bands (device scatter)')

    # coarsest: per-sample dense inverses.  On accelerators they are
    # computed ON DEVICE by batched Newton-Schulz iteration (dense
    # matmuls, no (B, nc, nc) upload).  On CPU the LAPACK host path below
    # is both exact and fastest.
    _tick('fine dinv + level structs')
    csys = lsys_cpu[-1]
    nc = csys.ndofs
    import numpy as _np

    if (jax.default_backend() != "cpu"
            and _os.environ.get("FEU_COARSE_DEV", "1") == "1"):
        Ainv = _coarse_inverse_device_dense(
            csys, D_vec, mu_vec,
            None if R_batches[-1] is None
            else np.asarray(R_batches[-1], dtype=np.float32))
        _tick('coarse inverses (device Newton-Schulz)')
        if _dbg:
            jax.block_until_ready(Ainv)
            _tick('coarse inverse dispatch wait')
        return MultilevelData(levels=tuple(levels), Ainv=Ainv,
                              free_c=lsys[-1].free,
                              omega=float(omega), D_vec=D_vec,
                              mu_vec=mu_vec,
                              R_batches=tuple([rbf_f32]
                                              + list(Rb_f32[:-1])))

    def dense_of(block, A_e):
        M = _np.zeros((nc, nc))
        dofs = _np.asarray(block.dofs)
        Ae = _np.asarray(A_e)
        for li in range(dofs.shape[1]):
            rows = dofs[:, li]
            for lj in range(dofs.shape[1]):
                _np.add.at(M, (rows, dofs[:, lj]), Ae[:, li, lj])
        return M

    K_c = dense_of(csys.K, csys.K.A64)
    Adv_c = (dense_of(csys.Adv, csys.Adv.A64)
             if csys.Adv is not None else None)
    R_c = dense_of(csys.R, csys.R.A64) if csys.R is not None else None
    free_c = _np.asarray(csys.free)

    def constrain(A):
        A[~free_c, :] = 0.0
        A[:, ~free_c] = 0.0
        idx = _np.flatnonzero(~free_c)
        A[idx, idx] = 1.0
        return A

    K_c = constrain(K_c)
    if Adv_c is not None:
        Adv_c = constrain(0.5 * (Adv_c + Adv_c.T))
    if R_c is not None:
        R_c = constrain(R_c)

    D_np = _np.asarray(D_vec)
    mu_np = _np.asarray(mu_vec)
    Rb_c = R_batches[-1]
    Ainvs = []
    for b in range(B):
        A = D_np[b] * K_c
        if Adv_c is not None:
            A = A + Adv_c
        if R_c is not None:
            if Rb_c is not None:
                A = A + constrain(dense_of(csys.R, Rb_c[b]))
            else:
                A = A + mu_np[b] * R_c
        A = A + 1e-6 * _np.abs(_np.diag(A)).mean() * _np.eye(nc)
        Ainvs.append(_np.linalg.inv(A.astype(_np.float32)))
    _tick('coarse dense build+inverses (host)')
    Ainv = jnp.asarray(_np.stack(Ainvs))

    if _dbg:
        jax.block_until_ready(Ainv)
        _tick('Ainv upload')
    return MultilevelData(levels=tuple(levels), Ainv=Ainv,
                          free_c=jnp.asarray(free_c),
                          omega=float(omega), D_vec=D_vec, mu_vec=mu_vec,
                          R_batches=tuple([rbf_f32]
                                          + list(Rb_f32[:-1])))


# device-side coarsest dense inverses: scatter the (already-shipped)
# coarse element arrays into (nc, nc), constrain, and invert the whole
# (B, nc, nc) batch by Newton-Schulz iteration X <- X(2I - AX).  With
# X0 = A^T/(|A|_1 |A|_inf) the iteration contracts for any nonsingular
# A; for these SPD-dominated coarse operators (cond <~1e4 at ~500 dofs)
# ~35 doublings reach f32 accuracy, i.e. a handful of (B,512,512)
# matmuls, zero host->device traffic.
_COARSE_INV_CACHE = {}


def _ns_iters():
    # 35 doublings reach the f32 accuracy floor for these coarse
    # operators (LAPACK-pinned tests pass down to 30); each iteration is
    # two (B, nc, nc) matmuls, so fewer iters shave setup dispatch time
    import os
    return int(os.environ.get("FEU_NS_ITERS", "35"))


def _coarse_inverse_program(key):
    prog = _COARSE_INV_CACHE.get(key)
    if prog is not None:
        return prog
    has_adv, has_R, has_Rb, iters = key[:4]

    def dense(dofs, Ae, nc):
        shp = Ae.shape
        r = jnp.broadcast_to(dofs[:, :, None], shp).reshape(-1)
        c = jnp.broadcast_to(dofs[:, None, :], shp).reshape(-1)
        return (jnp.zeros((nc, nc), jnp.float32)
                .at[r, c].add(Ae.reshape(-1).astype(jnp.float32)))

    def constrain(M, fmask):
        M = M * fmask[:, None] * fmask[None, :]
        return M + jnp.diag(1.0 - fmask)

    def ns_inv(A):
        hi = jax.lax.Precision.HIGHEST
        n1 = jnp.max(jnp.sum(jnp.abs(A), axis=0))
        ninf = jnp.max(jnp.sum(jnp.abs(A), axis=1))
        X = A.T / (n1 * ninf)
        I2 = 2.0 * jnp.eye(A.shape[0], dtype=A.dtype)

        def body(_, X):
            AX = jnp.matmul(A, X, precision=hi)
            return jnp.matmul(X, I2 - AX, precision=hi)

        return jax.lax.fori_loop(0, iters, body, X)

    def fn(Kd, Kv, Advd, Advv, Rd, Rv, Rb, free, D, mu):
        nc = free.shape[0]
        fmask = free.astype(jnp.float32)
        K = constrain(dense(Kd, Kv, nc), fmask)
        Adv = None
        if has_adv:
            M = dense(Advd, Advv, nc)
            Adv = constrain(0.5 * (M + M.T), fmask)
        Rfix = (constrain(dense(Rd, Rv, nc), fmask)
                if (has_R and not has_Rb) else None)

        def one(b):
            A = D[b].astype(jnp.float32) * K
            if Adv is not None:
                A = A + Adv
            if has_Rb:
                A = A + constrain(dense(Rd, Rb[b], nc), fmask)
            elif Rfix is not None:
                A = A + mu[b].astype(jnp.float32) * Rfix
            reg = 1e-6 * jnp.abs(jnp.diagonal(A)).mean()
            A = A + reg * jnp.eye(nc, dtype=A.dtype)
            X = ns_inv(A)
            # convergence certificate: ||I - A X||_max.  NS silently
            # stagnates on operators conditioned far beyond the assumed
            # ~1e4 (extreme D/mu ranges); surface that instead of
            # shipping a degraded preconditioner
            E = jnp.eye(nc, dtype=A.dtype) - jnp.matmul(
                A, X, precision=jax.lax.Precision.HIGHEST)
            return X, jnp.max(jnp.abs(E))

        # vmap: the NS iteration is 2 batched (B, nc, nc) matmuls; a
        # sequential lax.map issued 2*iters tiny matmuls PER SAMPLE
        # (1400 dispatches at B=20), measured 0.5 s where the batched
        # flops are worth ~10 ms.  Guard: at large nc the (B, nc, nc)
        # NS transients (A, X, AX) exceed HBM comfort -- stay sequential.
        B = D.shape[0]
        if B * nc * nc * 4 * 3 > (2 << 30):
            return jax.lax.map(one, jnp.arange(B))
        return jax.vmap(one)(jnp.arange(B))

    prog = jax.jit(fn)
    _COARSE_INV_CACHE[key] = prog
    return prog


def _dense_np(dofs, Ae, nc):
    import numpy as _np
    M = _np.zeros((nc, nc), dtype=_np.float32)
    dofs = _np.asarray(dofs)
    Ae = _np.asarray(Ae, dtype=_np.float32)
    for li in range(dofs.shape[1]):
        for lj in range(dofs.shape[1]):
            _np.add.at(M, (dofs[:, li], dofs[:, lj]), Ae[:, li, lj])
    return M


def _coarse_inverse_dense_program(key):
    """Scatter-free batched NS inverse: the (nc, nc) dense coarse
    matrices arrive PRE-ASSEMBLED (host numpy -- ~3 MB upload), so the
    device program is pure batched matmuls, with no in-program
    scatter assembly (`.at[r, c].add`)."""
    prog = _COARSE_INV_CACHE.get(key)
    if prog is not None:
        return prog
    has_adv, mode, iters = key[:3]

    def ns_inv(A):
        hi = jax.lax.Precision.HIGHEST
        n1 = jnp.max(jnp.sum(jnp.abs(A), axis=0))
        ninf = jnp.max(jnp.sum(jnp.abs(A), axis=1))
        X = A.T / (n1 * ninf)
        I2 = 2.0 * jnp.eye(A.shape[0], dtype=A.dtype)

        # unrolled (iters is static): XLA schedules the 2*iters
        # matmuls back-to-back instead of one loop step at a time
        for _ in range(iters):
            AX = jnp.matmul(A, X, precision=hi)
            X = jnp.matmul(X, I2 - AX, precision=hi)
        return X

    def fn(Kc, Advc, Rc, Rb_dense, free, D, mu):
        nc = free.shape[0]

        def one(b):
            A = D[b].astype(jnp.float32) * Kc
            if has_adv:
                A = A + Advc
            if mode == "rb":
                A = A + Rb_dense[b]
            elif mode == "r":
                A = A + mu[b].astype(jnp.float32) * Rc
            reg = 1e-6 * jnp.abs(jnp.diagonal(A)).mean()
            A = A + reg * jnp.eye(nc, dtype=A.dtype)
            X = ns_inv(A)
            E = jnp.eye(nc, dtype=A.dtype) - jnp.matmul(
                A, X, precision=jax.lax.Precision.HIGHEST)
            return X, jnp.max(jnp.abs(E))

        B = D.shape[0]
        if B * nc * nc * 4 * 3 > (2 << 30):
            return jax.lax.map(one, jnp.arange(B))
        return jax.vmap(one)(jnp.arange(B))

    prog = jax.jit(fn)
    _COARSE_INV_CACHE[key] = prog
    return prog


_AINV_DEV_MEMO: dict = {}


def _coarse_inverse_device_dense(csys, D_vec, mu_vec, Rb):
    """(B, nc, nc) f32 coarsest inverses: host dense assembly (the
    coarse level is ~500-2000 dofs; numpy add.at is microseconds) +
    batched device Newton-Schulz.  csys is the HOST coarse system.

    Content-memoised on device (same pattern as _TBAND_DEV_CACHE): a
    warm rebuild for the same (coarse operator, coefficients) reuses the
    computed inverses -- the NS dispatch + wait was ~0.7 s of the warm
    build floor, and studies rebuild the hierarchy for a geometry they
    have already set up (mu batches, sulcus/rect pairs, bench reps)."""
    import numpy as _np
    from ..utils.diskcache import cache_key_of
    memo_key = cache_key_of(
        "ainv-v1", _np.asarray(csys.K.A64), _np.asarray(csys.K.dofs),
        None if csys.Adv is None else _np.asarray(csys.Adv.A64),
        None if csys.R is None else _np.asarray(csys.R.A64),
        None if Rb is None else _np.asarray(Rb),
        _np.asarray(csys.free), _np.asarray(D_vec), _np.asarray(mu_vec),
        _ns_iters())
    hit = _AINV_DEV_MEMO.get(memo_key)
    if hit is not None:
        return hit
    nc = int(csys.ndofs)
    free_np = _np.asarray(csys.free)
    fmask = free_np.astype(_np.float32)

    def constrain_np(M):
        M = M * fmask[:, None] * fmask[None, :]
        M[_np.arange(nc), _np.arange(nc)] += 1.0 - fmask
        return M

    K_c = constrain_np(_dense_np(csys.K.dofs, csys.K.A64, nc))
    has_adv = csys.Adv is not None
    Adv_c = _np.zeros((1, 1), _np.float32)
    if has_adv:
        M = _dense_np(csys.Adv.dofs, csys.Adv.A64, nc)
        Adv_c = constrain_np(0.5 * (M + M.T))
    mode = "none"
    R_c = _np.zeros((1, 1), _np.float32)
    Rb_dense = _np.zeros((1, 1, 1), _np.float32)
    if Rb is not None:
        mode = "rb"
        # same constraint semantics as the in-program scatter path:
        # every constrained term carries its identity diagonal
        Rb_dense = _np.stack([
            constrain_np(_dense_np(csys.R.dofs, Rb[b], nc))
            for b in range(Rb.shape[0])])
    elif csys.R is not None:
        mode = "r"
        R_c = constrain_np(_dense_np(csys.R.dofs, csys.R.A64, nc))

    iters = _ns_iters()
    prog = _coarse_inverse_dense_program(
        (has_adv, mode, iters, nc, int(_np.asarray(D_vec).shape[0]),
         "dense"))
    Xs, res = prog(jnp.asarray(K_c), jnp.asarray(Adv_c), jnp.asarray(R_c),
                   jnp.asarray(Rb_dense), jnp.asarray(free_np),
                   jnp.asarray(D_vec), jnp.asarray(mu_vec))
    # The degradation warning must NOT force a host sync here: the
    # build is otherwise fully async (the caller blocks once on the
    # whole MG payload).  A daemon thread blocks on the tiny residual
    # scalar and warns when it materialises.
    worst_dev = jnp.max(res)

    def _warn_if_degraded():
        try:
            worst = float(worst_dev)
        except Exception:
            return
        if worst > 1e-2:
            import warnings
            warnings.warn(
                f"coarse Newton-Schulz inverse degraded: max ||I-AX|| ="
                f" {worst:.2e} over the batch (cond beyond the ~1e4 "
                f"design point?); raise FEU_NS_ITERS or expect extra "
                f"CG iterations", RuntimeWarning)

    import threading
    threading.Thread(target=_warn_if_degraded, daemon=True).start()
    _AINV_DEV_MEMO[memo_key] = Xs
    while len(_AINV_DEV_MEMO) > 4:     # (B, nc, nc) f32 each, ~20 MB
        _AINV_DEV_MEMO.pop(next(iter(_AINV_DEV_MEMO)))
    return Xs


def _coarse_inverse_device(csys_d, D_vec, mu_vec, Rb):
    """(B, nc, nc) f32 coarsest inverses, computed on-device from the
    shipped coarse TransportSystem (no dense upload)."""
    has_adv = csys_d.Adv is not None
    has_R = csys_d.R is not None
    has_Rb = Rb is not None
    iters = _ns_iters()
    key = (has_adv, has_R, has_Rb, iters, int(csys_d.ndofs),
           tuple(csys_d.K.A32.shape),
           None if not has_adv else tuple(csys_d.Adv.A32.shape),
           None if not has_R else tuple(csys_d.R.A32.shape),
           None if not has_Rb else tuple(Rb.shape),
           int(np.asarray(D_vec).shape[0]))
    prog = _coarse_inverse_program(key)
    z2 = jnp.zeros((1, 1), jnp.int32)
    z3 = jnp.zeros((1, 1, 1), jnp.float32)
    Xs, res = prog(csys_d.K.dofs, csys_d.K.A32,
                   csys_d.Adv.dofs if has_adv else z2,
                   csys_d.Adv.A32 if has_adv else z3,
                   csys_d.R.dofs if has_R else z2,
                   csys_d.R.A32 if has_R else z3,
                   Rb if has_Rb else z3[None],
                   csys_d.free, jnp.asarray(D_vec), jnp.asarray(mu_vec))
    worst = float(jnp.max(res))
    if worst > 1e-2:
        import warnings
        warnings.warn(
            f"coarse Newton-Schulz inverse degraded: max ||I-AX|| = "
            f"{worst:.2e} over the batch (cond beyond the ~1e4 design "
            f"point?); raise FEU_NS_ITERS or expect extra CG iterations",
            RuntimeWarning)
    return Xs


# f32 products inside the V-cycle run at full f32 precision: a GPU
# would otherwise take TF32 (about three decimal digits), which moves
# the preconditioner and with it the Krylov iteration counts
_HI = jax.lax.Precision.HIGHEST

# structure-keyed program cache: like parallel/sweep.py's operator
# programs, ALL arrays (element matrices, transfers, diagonals, coarsest
# inverses, coefficients) enter as arguments so the compiled V-cycle is
# shared across mu batches and same-bucket meshes
_ML_PROG_CACHE = {}


class _LevelArgs(NamedTuple):
    K: "object"               # _BlockArgs
    Adv: "object"             # _BlockArgs or None
    R: "object"               # _BlockArgs or None
    R_batch: "object"         # (B,F,nd,nd) or None
    free: jnp.ndarray
    dinv: jnp.ndarray         # (n_l, B)
    t_cols: jnp.ndarray       # transfer to next coarser level
    t_w: jnp.ndarray
    t_perm: jnp.ndarray
    t_ids: jnp.ndarray
    # windowed-band transfers (None = gather/segment-sum path)
    tb_p: "object" = None     # prolong (T, R, W) f32
    tb_po: "object" = None    # prolong (T,) int32 offsets
    tb_r: "object" = None     # restrict band
    tb_ro: "object" = None    # restrict offsets
    tb_sig: "object" = None   # (nc,) coarse alignment permutation
    tb_isig: "object" = None  # (nc,) its inverse


def _ml_dtype(f32):
    """Smoothing dtype: f32 default; FEU_ML_BF16=1 runs the V-cycle's
    element applies/vectors in bf16 (the fine-level gathers dominate the
    per-iteration cost; M-internal precision only affects CG iteration
    counts, not the solution)."""
    import os
    if not f32:
        return jnp.float64
    if os.environ.get("FEU_ML_BF16", "0") == "1":
        return jnp.bfloat16
    return jnp.float32


def _ml_tb_bf16():
    """Store the windowed-band MG TRANSFER operators (tb_p / tb_r) in
    bf16.  They are the largest V-cycle byte stream at study scale
    (~407 MB of the 1310 MB modeled bytes per hybrid CG iteration --
    the fine restrict band alone is (128, 256, 1536) = 201 MB), and
    they live entirely inside the preconditioner M: rounding P and
    P^T entrywise from the same f64 values keeps restrict == prolong^T
    exactly, so M stays symmetric and CG theory is untouched -- only
    the iteration count can move.

    FEU_ML_TB_BF16=1 enables."""
    import os
    return os.environ.get("FEU_ML_TB_BF16", "0") == "1"


def _ml_smooth_steps():
    """V(nu,nu) smoothing count (FEU_ML_SMOOTH, default 1).  With the
    banded fine-level apply the marginal smoothing step is cheap; more
    steps trade apply count for CG iterations."""
    import os
    return max(1, int(os.environ.get("FEU_ML_SMOOTH", "1")))


def _ml_cycle():
    """Cycle type: 'mult' = multiplicative V(nu,nu) (fewest iterations),
    'add' = additive/BPX (scaled Jacobi + coarse terms summed, ZERO
    operator applies inside M -- each CG iteration costs only the CG
    operator apply + transfer chains, trading ~1.5-2x more iterations
    for a much cheaper cycle)."""
    import os
    return os.environ.get("FEU_ML_CYCLE", "mult")


def _ml_band_in_M():
    """Whether the V-cycle's level applies run in banded (dense tile
    matvec, ops/banded.band_apply) form instead of the element path
    (FEU_ML_BAND=1; off by default)."""
    import os
    return os.environ.get("FEU_ML_BAND", "0") == "1"


def _ml_tband():
    """Windowed-band MG transfers (ops/banded.rect_band_apply_ref) in
    place of the gather/segment-sum pair (FEU_ML_TBAND=1; off by
    default: on the H100 the gather transfers measured faster, PERF.md)."""
    import os
    return os.environ.get("FEU_ML_TBAND", "0") == "1"


_TBAND_DEV_CACHE: dict = {}
_TBAND_PLAN_MEMO: dict = {}
_SHIP_MEMO: dict = {}


def _aligned_plans_cached(cols, w, nf, nc_l):
    """Disk-cached aligned_transfer_plans (ops/banded.py): the plan is
    pure in (cols, weights, sizes) and costs ~50-100 ms of host argsorts
    per level per process otherwise.  Returns (content_key, plans)."""
    from ..ops.banded import RectBandPlan, aligned_transfer_plans
    from ..utils.diskcache import cache_key_of, cached_arrays
    key = cache_key_of("tbandplan-v3", cols, w, nf, nc_l)
    if key in _TBAND_PLAN_MEMO:      # a None plan (nonlocal) hits too
        return key, _TBAND_PLAN_MEMO[key]

    def _build():
        r = aligned_transfer_plans(cols, w, nf, nc_l)
        if r is None:
            return {"none": np.asarray([1])}
        p, q, sig, isig = r
        d = {"sig": sig, "isig": isig}
        for tag, pl_ in (("p", p), ("r", q)):
            d[tag + "_offs"] = pl_.offs
            d[tag + "_ids"] = pl_.ids
            d[tag + "_perm"] = pl_.perm
            d[tag + "_dims"] = np.asarray(
                [pl_.tiles, pl_.tile, pl_.width,
                 pl_.n_rows_pad, pl_.n_cols_pad])
        return d

    data, _hit = cached_arrays("tbandplan", key, _build)
    if "none" in data:
        _TBAND_PLAN_MEMO[key] = None
        return key, None

    def mk(tag):
        t, r_, w_, nrp, ncp = [int(x) for x in data[tag + "_dims"]]
        return RectBandPlan(offs=data[tag + "_offs"],
                            ids=data[tag + "_ids"],
                            perm=data[tag + "_perm"],
                            tiles=t, tile=r_, width=w_,
                            n_rows_pad=nrp, n_cols_pad=ncp)

    out = (mk("p"), mk("r"), data["sig"], data["isig"])
    _TBAND_PLAN_MEMO[key] = out
    while len(_TBAND_PLAN_MEMO) > 6:
        _TBAND_PLAN_MEMO.pop(next(iter(_TBAND_PLAN_MEMO)))
    return key, out




def _tband_values_all(plans, vals):
    """Transfer-band scatters, one cached program PER PLAN SHAPE.

    A single fused program (round 3) keyed on the concatenation of all
    six (entries, segments) pairs recompiled whenever ANY level of a new
    geometry differed -- a full recompile per study geometry.
    Per-plan programs are keyed on their own (M, segs) pair, which the
    level size buckets + the W menu keep stable across geometries; the
    extra dispatches cost ~0.1 s each only on the cache-miss path
    (_TBAND_DEV_CACHE serves warm rebuilds with zero dispatches)."""
    from ..ops.banded import _rect_values_program
    outs = []
    for p, v in zip(plans, vals):
        M = int(np.asarray(p.ids).shape[0])
        segs = p.tiles * p.tile * p.width + 1
        prog = _rect_values_program(M, segs)
        flat = prog(jnp.asarray(v), jnp.asarray(p.perm),
                    jnp.asarray(p.ids))
        outs.append(flat.reshape(p.tiles, p.tile, p.width))
    return outs


def _ml_struct_key(ml: MultilevelData, f32: bool, cycle=None):
    from ..parallel.sweep import sys_struct_key
    lv = tuple(
        (sys_struct_key(lev.sys), lev.transfer.n_coarse,
         ml.R_batches[i] is not None,
         # windowed-band transfer statics: X pad lengths (trace-time
         # constants; band T/R/W ride in the traced array shapes)
         None if lev.bands is None else
         (int(lev.bands[1].n_cols_pad), int(lev.bands[3].n_cols_pad)))
        for i, lev in enumerate(ml.levels))
    return (lv, int(ml.Ainv.shape[1]), str(_ml_dtype(f32)),
            _ml_smooth_steps(), cycle or _ml_cycle(), _ml_tb_bf16())


def _ml_program(struct_key):
    hit = _ML_PROG_CACHE.get(struct_key)
    if hit is not None:
        return hit
    from ..parallel.sweep import _args_block_apply
    level_structs, nc, _dt_tag, n_smooth, cycle, _tb_bf16 = struct_key
    n_mid = len(level_structs)
    ndofs_l = [s[0][0] for s in level_structs]
    ncoarse_l = [s[1] for s in level_structs]
    band_pads = [s[3] if len(s) > 3 else None for s in level_structs]

    from ..ops.banded import rect_band_apply_ref as _rect_apply

    def A_level(l, la: _LevelArgs, X, D_vec, mu_vec):
        Y = _args_block_apply(la.K, ndofs_l[l], X,
                              coef=D_vec.astype(X.dtype))
        if la.Adv is not None:
            Y = Y + _args_block_apply(la.Adv, ndofs_l[l], X)
        if la.R is not None:
            if la.R_batch is None:
                Y = Y + _args_block_apply(la.R, ndofs_l[l], X,
                                          coef=mu_vec.astype(X.dtype))
            else:
                Y = Y + _args_block_apply(la.R, ndofs_l[l], X,
                                          A_batch=la.R_batch)
        return jnp.where(la.free[:, None], Y,
                         X)  # constrained rows: identity

    def A_masked(l, la, X, D_vec, mu_vec):
        return A_level(l, la, jnp.where(la.free[:, None], X, 0.0),
                       D_vec, mu_vec)

    def restrict(l, la: _LevelArgs, R):
        n_coarse = ncoarse_l[l]
        if la.tb_r is not None:
            pad_r = band_pads[l][1]
            Xq = jnp.pad(R, ((0, pad_r - R.shape[0]), (0, 0)))
            Ys = _rect_apply(la.tb_r, la.tb_ro, Xq)[:n_coarse]
            # band rows are in the fine-aligned sigma order
            return Ys[la.tb_isig].astype(R.dtype)
        contrib = la.t_w[:, :, None] * R[:, None, :]
        n, _, B = contrib.shape
        flat = contrib.reshape(n * 3, B)[la.t_perm]
        return jax.ops.segment_sum(flat, la.t_ids,
                                   num_segments=n_coarse,
                                   indices_are_sorted=True)

    def prolong(l, la: _LevelArgs, Xc):
        if la.tb_p is not None:
            pad_p = band_pads[l][0]
            Xs = Xc[la.tb_sig]       # fine-aligned sigma order
            Xq = jnp.pad(Xs, ((0, pad_p - Xs.shape[0]), (0, 0)))
            return _rect_apply(la.tb_p, la.tb_po,
                               Xq)[:ndofs_l[l]].astype(Xc.dtype)
        return jnp.einsum("nk,nkb->nb", la.t_w, Xc[la.t_cols],
                          precision=_HI, preferred_element_type=Xc.dtype)

    def vcycle(l, r, levels, free_c, Ainv, D_vec, mu_vec, omega):
        la = levels[l]
        x = omega * la.dinv * r                 # first step from zero
        for _ in range(n_smooth - 1):
            x = x + omega * la.dinv * (r - A_masked(l, la, x, D_vec,
                                                    mu_vec))
        res = r - A_masked(l, la, x, D_vec, mu_vec)
        rc = restrict(l, la, res)
        if l + 1 < n_mid:
            rc = jnp.where(levels[l + 1].free[:, None], rc, 0.0)
            xc = vcycle(l + 1, rc, levels, free_c, Ainv, D_vec, mu_vec,
                        omega)
        else:
            rc = jnp.where(free_c[:, None], rc, 0.0)
            xc_b = jnp.matmul(Ainv, jnp.moveaxis(rc, 1, 0)[..., None],
                              precision=_HI,
                              preferred_element_type=jnp.float32)
            xc = jnp.moveaxis(xc_b[..., 0], 0, 1)
        x = x + prolong(l, la, xc)
        # mirrored post-smooth keeps M symmetric (CG-safe)
        for _ in range(n_smooth):
            x = x + omega * la.dinv * (r - A_masked(l, la, x, D_vec,
                                                    mu_vec))
        return x

    def additive(m_args, R):
        """BPX-style additive preconditioner: restrict the residual down
        the hierarchy, apply scaled Jacobi at every smoothing level and
        the dense inverse at the coarsest, prolong-accumulate back up.
        Symmetric PSD (each term is P...omega*D^-1...P^T); contains NO
        operator applies, so a CG iteration costs only the (banded) CG
        operator + the transfer chains."""
        levels, free_c, Ainv, D_vec, mu_vec, omega = m_args
        rs = [R.astype(D_vec.dtype)]
        for l in range(n_mid):
            la = levels[l]
            rc = restrict(l, la, rs[-1])
            rc = jnp.where((levels[l + 1].free if l + 1 < n_mid
                            else free_c)[:, None], rc, 0.0)
            rs.append(rc)
        xc_b = jnp.matmul(Ainv, jnp.moveaxis(rs[-1], 1, 0)[..., None],
                          precision=_HI, preferred_element_type=jnp.float32)
        c = jnp.moveaxis(xc_b[..., 0], 0, 1).astype(rs[-1].dtype)
        for l in range(n_mid - 1, -1, -1):
            la = levels[l]
            c = omega * la.dinv * rs[l] + prolong(l, la, c)
        return c.astype(R.dtype)

    def hybrid(m_args, R):
        """Additive at the FINE level (scaled Jacobi + prolongated
        coarse correction -- zero fine-level operator applies, the
        per-iteration bottleneck), multiplicative V-cycle below (the
        mid levels are ~25x smaller, so their smoothing applies are
        cheap).  Symmetric PSD: sum of two symmetric PSD terms."""
        levels, free_c, Ainv, D_vec, mu_vec, omega = m_args
        la = levels[0]
        Rw = R.astype(D_vec.dtype)
        rc = restrict(0, la, Rw)
        if n_mid > 1:
            rc = jnp.where(levels[1].free[:, None], rc, 0.0)
            xc = vcycle(1, rc, levels, free_c, Ainv, D_vec, mu_vec,
                        omega)
        else:
            rc = jnp.where(free_c[:, None], rc, 0.0)
            xc_b = jnp.matmul(Ainv, jnp.moveaxis(rc, 1, 0)[..., None],
                              precision=_HI,
                              preferred_element_type=jnp.float32)
            xc = jnp.moveaxis(xc_b[..., 0], 0, 1).astype(rc.dtype)
        out = omega * la.dinv * Rw + prolong(0, la, xc)
        return out.astype(R.dtype)

    def apply(m_args, R):
        levels, free_c, Ainv, D_vec, mu_vec, omega = m_args
        Rw = R.astype(D_vec.dtype)
        out = vcycle(0, Rw, levels, free_c, Ainv, D_vec, mu_vec, omega)
        return out.astype(R.dtype)

    if cycle == "add":
        apply = additive
    elif cycle == "hybrid":
        apply = hybrid
    _ML_PROG_CACHE[struct_key] = apply
    return apply


def ml_preconditioner_args(ml: MultilevelData, f32=True, band=True):
    """The runtime argument pytree for the cached V-cycle program.

    band=False drops the banded operator arrays (sharded path: the
    fine level is cells-partitioned there and a replicated band would
    cost full-system HBM per device)."""
    from ..parallel.sweep import _BlockArgs
    dt = _ml_dtype(f32)
    levels = []
    for i, lev in enumerate(ml.levels):
        s = lev.sys
        Rb = ml.R_batches[i]
        if not band:
            s = s._replace(Kband=None, Advband=None)
        def _ba(blk, band=None):
            ba = _BlockArgs.of(blk, f32, band=band)
            if dt == jnp.bfloat16:
                ba = ba._replace(A=ba.A.astype(dt))
                if ba.band is not None:
                    ba = ba._replace(band=ba.band.astype(dt))
            return ba

        # the f64 V-cycle variant (Stokes Mv64) keeps the gather-path
        # transfers: the windowed bands are stored f32 and would round
        # the f64 preconditioner's transfer arithmetic
        tb = lev.bands if dt != jnp.float64 else None
        tb_dt = (jnp.bfloat16 if tb is not None
                 and (dt == jnp.bfloat16 or _ml_tb_bf16())
                 else None)

        def _tb_band(b):
            return b if tb_dt is None else b.astype(tb_dt)
        levels.append(_LevelArgs(
            K=_ba(s.K, band=s.Kband),
            Adv=None if s.Adv is None else _ba(s.Adv, band=s.Advband),
            R=None if s.R is None else _ba(s.R),
            R_batch=None if Rb is None else jnp.asarray(Rb).astype(dt),
            free=lev.free,
            dinv=lev.dinv.astype(dt),
            t_cols=lev.transfer.cols,
            t_w=lev.transfer.weights.astype(dt),
            t_perm=lev.transfer.perm,
            t_ids=lev.transfer.ids_sorted,
            tb_p=None if tb is None else _tb_band(tb[0].band),
            tb_po=None if tb is None else tb[0].offs,
            tb_r=None if tb is None else _tb_band(tb[2].band),
            tb_ro=None if tb is None else tb[2].offs,
            tb_sig=None if tb is None else tb[4],
            tb_isig=None if tb is None else tb[5],
        ))
    return (tuple(levels), ml.free_c, ml.Ainv,
            ml.D_vec.astype(dt), ml.mu_vec.astype(dt),
            jnp.asarray(ml.omega, dtype=dt))


def build_multilevel_for(sys, mesh, D_values, mu_values=None,
                         mu_callables=None, robin_matrices_fine=None,
                         u_fine=None, h_threshold=0.08, omega=0.65):
    """Convenience: full MG hierarchy for a study sweep, or None if the
    mesh is coarse enough that Jacobi alone converges quickly.

    mu_callables: per-sample spatially-varying mu(x) (step-mu sweeps) --
    the level Robin matrices are assembled from them on each level mesh.
    u_fine: fine-mesh velocity Function; it is interpolated onto each
    level mesh so the level operators include advection.
    """
    g = mesh.geom
    if g is None or g.mesh_size >= h_threshold:
        return None
    level_meshes = level_meshes_for(mesh)
    from ..parallel.sweep import build_transport_system

    robin_levels = None
    if mu_callables is not None:
        from ..fem.assembly import robin_facet_block
        from ..fem.space import FunctionSpace
        from ..meshing.mesh_data import MARKERS
        robin_levels = []
        for m in level_meshes:
            sp = FunctionSpace(m, "P1")
            bottom = m.bc_marker == MARKERS["bottom"]
            robin_levels.append(jnp.stack([
                robin_facet_block(sp, bottom, mu=mc).A_e
                for mc in mu_callables]))

    u_levels = None
    if u_fine is not None:
        from ..analysis.profiles import eval_function
        from ..fem.space import Function, FunctionSpace
        u_levels = []
        for m in level_meshes:
            if m is mesh:
                # nested same-mesh level: the fine velocity field IS the
                # level field (skip the 1e5-point location pass)
                u_levels.append((u_fine.values, u_fine.space))
                continue
            Vl = FunctionSpace(m, "P2", vs=2)
            vals, ok = eval_function(u_fine, Vl.dof_coords)
            vals = np.where(ok[:, None], vals, 0.0)
            inter = np.zeros(Vl.ndofs)
            inter[0::2] = vals[:, 0]
            inter[1::2] = vals[:, 1]
            u_levels.append((jnp.asarray(inter), Vl))

    return build_multilevel(sys, level_meshes, D_values,
                            mu_values=mu_values,
                            robin_matrices_levels=robin_levels,
                            robin_matrices_fine=robin_matrices_fine,
                            u_levels=u_levels, omega=omega)


def make_ml_preconditioner(ml: MultilevelData, f32=True, cycle=None):
    """M^{-1}: (n, B) -> (n, B) as one multigrid cycle.

    cycle: 'mult' | 'add' | 'hybrid' (None -> _ml_cycle(), i.e. the
    FEU_ML_CYCLE env or 'mult').  All three are symmetric PSD, so the
    choice only moves the CG iteration count / per-iteration cost
    trade-off, never the solution.

    Returned as an (fn, args) pair (solvers/batched.py convention); the
    fn is cached by structure so Krylov chunks compile once per shape
    bucket and are reused across mu batches, meshes, and studies.
    """
    band = _ml_band_in_M()
    apply = _ml_program(_ml_struct_key(ml, f32, cycle))
    return (apply, ml_preconditioner_args(ml, f32=f32, band=band))
