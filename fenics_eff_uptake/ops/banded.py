"""Banded-dense form of the assembled operator.

The element-scatter apply (ops/elemspmv.py, parallel/sweep.py:_Block)
is gather -> tiny matmul -> segment-sum, whose random row gather/scatter
of (n, B) batch-minor arrays is irregular memory traffic.

This module trades that irregular traffic for regular dense work.  The dof graph of a 2-D FEM mesh has O(sqrt(n)) bandwidth
under a reverse-Cuthill-McKee ordering (measured: 643 at ~1e5 P2 dofs
on the default study mesh, vs ~1e5 natural).  After RCM the assembled
matrix fits in a block-banded form:

    band[t, r, w] = A[t*R + r, (t - halo)*R + w]

with row tiles of R rows and a window of W = (2*halo + 1)*R columns,
halo = ceil(max |i - j| / R).  The apply is then ONE batched dense
matmul per operator:

    Y[t] = band[t] @ X_window[t]          # (R, W) @ (W, B)

where the X windows are built from shifted reshapes (contiguous
copies, no gather).  The price is the band's zeros: at the study mesh
(n ~ 1e5) the f32 band holds several hundred MB.

The band stores the raw assembled matrix (no Dirichlet masking baked
in); constraint semantics stay in the caller exactly as for the
element path.  f64 outer-defect applies keep using the element path
(the band is the f32 inner-Krylov workhorse).

No reference-code counterpart: the reference delegates SpMV to PETSc
(ref solvers.py:55,151); this layout is one answer to SURVEY.md 7.3
item 5 (irregular sparsity on a dense-matrix machine).
"""

from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BandPlan", "rcm_permutation", "best_bandwidth_permutation",
           "build_band_plan", "band_from_elements", "band_apply",
           "RectBandPlan", "build_rect_band_plan", "rect_band_values",
           "rect_band_apply_ref", "aligned_transfer_plans"]


class BandPlan(NamedTuple):
    """Host-built scatter plan: element entries -> band slots."""
    perm: jnp.ndarray         # (N*nd*nd,) argsort of flat band ids
    ids_sorted: jnp.ndarray   # (N*nd*nd,) sorted flat ids (row*W + w)
    tiles: int                # T
    tile: int                 # R (rows per tile)
    width: int                # W = (2*halo + 1) * R
    halo: int


def rcm_permutation(entity_dofs: np.ndarray, ndofs_true: int,
                    ndofs_padded: int):
    """Reverse-Cuthill-McKee ordering of the dof graph.

    entity_dofs: (N, nd) cell dof map (true cells only, or padded --
    dummy-dof rows produce self-loops, which are harmless).
    Returns (new2old, old2new) int32 arrays over the PADDED dof range;
    padding dofs keep their (tail) positions.
    """
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ed = np.asarray(entity_dofs)
    ed = ed[(ed < ndofs_true).all(axis=1)]     # drop padding entities
    nd = ed.shape[1]
    rows = np.repeat(ed, nd, axis=1).ravel()
    cols = np.tile(ed, (1, nd)).ravel()
    A = sps.coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)),
        shape=(ndofs_true, ndofs_true)).tocsr()
    p = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                   dtype=np.int64)
    new2old = np.concatenate(
        [p, np.arange(ndofs_true, ndofs_padded, dtype=np.int64)])
    old2new = np.empty(ndofs_padded, dtype=np.int64)
    old2new[new2old] = np.arange(ndofs_padded)
    return (new2old.astype(np.int32), old2new.astype(np.int32))


def _spread_of(entity_dofs, old2new):
    e = old2new.astype(np.int64)[np.asarray(entity_dofs)]
    return int((e.max(axis=1) - e.min(axis=1)).max())


def best_bandwidth_permutation(entity_dofs: np.ndarray,
                               dof_coords: np.ndarray,
                               ndofs_true: int, ndofs_padded: int):
    """Minimum-spread dof ordering: RCM vs geometric sweep.

    On elongated domains (the studies' 10:1 sulcus channel) a plain
    lexicographic (x, y) sweep beats RCM substantially (measured 357 vs
    643 at ~1e5 P2 dofs), and band HBM bytes -- the banded apply's cost
    -- scale with the spread.  Returns the (new2old, old2new) pair with
    the smaller graph spread."""
    cand = [rcm_permutation(entity_dofs, ndofs_true, ndofs_padded)]
    if dof_coords is not None and len(dof_coords) >= ndofs_true:
        xy = np.asarray(dof_coords)[:ndofs_true]
        order = np.lexsort((xy[:, 1], xy[:, 0]))
        n2o = np.concatenate(
            [order.astype(np.int64),
             np.arange(ndofs_true, ndofs_padded, dtype=np.int64)])
        o2n = np.empty(ndofs_padded, dtype=np.int64)
        o2n[n2o] = np.arange(ndofs_padded)
        cand.append((n2o.astype(np.int32), o2n.astype(np.int32)))
    ed = np.asarray(entity_dofs)
    ed = ed[(ed < ndofs_true).all(axis=1)]
    return min(cand, key=lambda c: _spread_of(ed, c[1]))


def build_band_plan(entity_dofs: np.ndarray, ndofs: int,
                    tile: int = 256) -> BandPlan:
    """Band scatter plan for (already permuted) entity dofs.

    ndofs must be a multiple of `tile` (shape bucketing guarantees it).
    """
    ed = np.asarray(entity_dofs, dtype=np.int64)
    if ndofs % tile:
        raise ValueError(f"ndofs {ndofs} not a multiple of tile {tile}")
    spread = int((ed.max(axis=1) - ed.min(axis=1)).max())
    halo = max(1, -(-spread // tile))
    # quantise the halo to a short menu: W enters every banded program's
    # shape, so a per-geometry halo would recompile the full solver
    # stack per geometry class in multi-mesh studies.  The menu is
    # deliberately SPARSE around the study-scale range: h=0.02 sulcus
    # meshes straddle halo 3/4, and carrying both shapes recompiled the
    # Stokes MINRES chunk for half the geometries -- one padded-out halo
    # costs ~25% more band zeros but compiles once.
    for h in (1, 2, 4, 8, 16, 32):
        if h >= halo:
            halo = h
            break
    W = (2 * halo + 1) * tile
    T = ndofs // tile
    nd = ed.shape[1]
    rows = ed[:, :, None]                        # (N, nd, 1)
    cols = ed[:, None, :]                        # (N, 1, nd)
    t = rows // tile
    w = cols - (t - halo) * tile                 # in [0, W)
    flat = (rows * W + w).ravel()
    order = np.argsort(flat, kind="stable")
    return BandPlan(
        perm=jnp.asarray(order, dtype=jnp.int32),
        ids_sorted=jnp.asarray(flat[order], dtype=jnp.int32),
        tiles=T, tile=tile, width=W, halo=halo)


@partial(jax.jit, static_argnames=("tiles", "tile", "width"))
def _band_scatter_dev(A_e, perm, ids_sorted, dtype, tiles, tile, width):
    vals = A_e.astype(dtype.dtype).reshape(-1)[perm]
    flat = jax.ops.segment_sum(
        vals, ids_sorted, num_segments=tiles * tile * width,
        indices_are_sorted=True)
    return flat.reshape(tiles, tile, width)


def band_from_elements(A_e, plan: BandPlan, dtype=jnp.float32):
    """Scatter element matrices (N, nd, nd) into the (T, R, W) band.

    One jitted program (cast + gather + segment-sum + reshape) instead
    of 4 eager dispatches per band build."""
    z = jnp.zeros((), dtype=dtype)
    return _band_scatter_dev(jnp.asarray(A_e), plan.perm,
                             plan.ids_sorted, z, plan.tiles, plan.tile,
                             plan.width)


# ---------------------------------------------------------------------------
# Rectangular windowed bands: MG transfer operators as dense matmuls.
#
# The V-cycle's restriction/prolongation are a (3n, B) gather + sorted
# segment-sum.  Both directions are sparse RECTANGULAR matrices whose nonzeros cluster near
# the diagonal of the fine<->coarse index map when both orderings are
# geometric (the same locality the square operator band exploits).  Stored
# as per-row-tile windows with a PER-TILE column offset (the row/col
# ratio is non-integer, so windows slide rather than step):
#
#     Y[t*R + r] = sum_w band[t, r, w] * X[offs[t] + w]
#
# one (R, W) @ (W, B) matmul per tile, zero gather/scatter.  Offsets
# are runtime data; T/R/W stay in the compile key so
# same-bucket geometries share programs.
# ---------------------------------------------------------------------------


class RectBandPlan(NamedTuple):
    """Host plan for a sparse (n_rows x n_cols) -> windowed band."""
    offs: np.ndarray          # (T,) int32 window start per row tile
    ids: np.ndarray           # (M,) int32 SORTED flat band slots
                              #   (dump slot T*R*W for zero entries)
    perm: np.ndarray          # (M,) int32 argsort applied to entries
    tiles: int                # T
    tile: int                 # R
    width: int                # W (menu-quantised)
    n_rows_pad: int           # T * R
    n_cols_pad: int           # X must be zero-padded to this length


_RECT_W_MENU = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def build_rect_band_plan(rows, cols, vals, n_rows, n_cols, tile=256,
                         max_bytes=500 * 2**20):
    """Plan a windowed band for sparse entries (rows, cols, vals).

    Zero-valued entries (padded/constrained transfer rows) are routed to
    a dump slot so the entry COUNT stays bucket-shape-stable while the
    window covers live entries only.  `tile` is an upper bound: when the
    row/col ratio is large (restriction from a much bigger fine space)
    the tile shrinks so each tile's window fits the W menu.  Returns
    None when the ordering gives no locality (band would exceed
    max_bytes at every tile size) -- callers fall back to the
    gather/segment-sum path.
    """
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    live = vals != 0
    for t_r in (256, 128, 64, 32, 16, 8):
        if t_r > tile:
            continue
        T = -(-n_rows // t_r)
        tidx = rows // t_r
        # per-tile live column range
        mn = np.full(T, np.iinfo(np.int64).max)
        mx = np.full(T, -1)
        np.minimum.at(mn, tidx[live], cols[live])
        np.maximum.at(mx, tidx[live], cols[live])
        empty = mx < 0
        mn[empty] = 0
        mx[empty] = 0
        # 16-aligned window starts: covers f32's (8, 128) sublane DMA
        # alignment AND bf16's packed (16, 128) VMEM tiling, so the
        # same plan serves both band dtypes (the kernel asserts the
        # alignment via pl.multiple_of -- Mosaic cannot prove
        # divisibility of runtime SMEM offsets on its own)
        offs = (mn // 16) * 16
        need = int((mx - offs).max()) + 1
        W = next((w for w in _RECT_W_MENU if w >= need), None)
        if W is None or T * t_r * W * 4 > max_bytes:
            continue
        n_cols_pad = max(int((offs + W).max()),
                         -(-n_cols // 128) * 128)
        # quantise the X pad length: n_cols_pad enters the band-apply
        # program's traced shape (and through it every V-cycle / MINRES
        # chunk struct key), so a raw per-geometry value recompiled the
        # whole solver stack for every new mesh of a study.
        # 2048-multiples cost <2% extra
        # zero-pad on the (n_cols_pad, B) window copy.
        n_cols_pad = -(-n_cols_pad // 2048) * 2048
        w_idx = cols - offs[tidx]
        flat = (tidx * t_r + rows % t_r) * W + w_idx
        flat = np.where(live, flat, T * t_r * W)   # dump slot
        perm = np.argsort(flat, kind="stable")
        return RectBandPlan(offs=offs.astype(np.int32),
                            ids=flat[perm].astype(np.int32),
                            perm=perm.astype(np.int32),
                            tiles=T, tile=t_r, width=W,
                            n_rows_pad=T * t_r,
                            n_cols_pad=int(n_cols_pad))
    return None


def aligned_transfer_plans(cols, weights, n_fine, n_coarse, tile=256,
                           max_bytes=500 * 2**20):
    """Windowed-band plans for BOTH transfer directions of an MG level,
    with the coarse side re-ordered for window locality.

    Adjacent MG levels carry independently-chosen dof orderings (each
    optimises its OWN operator band), so the fine->coarse index map is
    not monotone and naive windows blow up (measured need ~2310 vs the
    ~150 a monotone map gives at 1e5 dofs).  Sorting the coarse dofs by
    their first fine contributor makes the entry cloud near-diagonal BY
    CONSTRUCTION; the apply pays one coarse-sized (nc, B) gather per
    direction -- ~12x smaller than the fine-sized gathers this replaces.

    Returns (plan_p, plan_r, sig, inv_sig) or None; sig maps
    sigma-ordered coarse indices to true ones (Xc_sigma = Xc[sig]),
    inv_sig the inverse (Y = Y_sigma[inv_sig]).
    """
    cols = np.asarray(cols)
    w = np.asarray(weights)
    nf, nd = cols.shape
    rows = np.repeat(np.arange(nf), nd)
    cflat = cols.ravel().astype(np.int64)
    wflat = w.ravel()
    live = wflat != 0
    key = np.full(n_coarse, np.iinfo(np.int64).max)
    np.minimum.at(key, cflat[live], rows[live])
    sig = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty(n_coarse, np.int32)
    inv[sig] = np.arange(n_coarse, dtype=np.int32)
    c2 = inv[cflat]
    p_p = build_rect_band_plan(rows, c2, wflat, nf, n_coarse,
                               tile=tile, max_bytes=max_bytes)
    p_r = build_rect_band_plan(c2, rows, wflat, n_coarse, nf,
                               tile=tile, max_bytes=max_bytes)
    if p_p is None or p_r is None:
        return None
    return p_p, p_r, sig, inv


def _rect_values_program(M, segs):
    """Cached jitted scatter: entries -> flat band (+ dump slot)."""
    key = ("rectvals", M, segs)
    prog = _RECT_PROG_CACHE.get(key)
    if prog is None:
        @jax.jit
        def prog(vals, perm, ids):
            return jax.ops.segment_sum(
                vals.ravel()[perm], ids, num_segments=segs,
                indices_are_sorted=True)[:-1]
        _RECT_PROG_CACHE[key] = prog
    return prog


_RECT_PROG_CACHE: dict = {}


def rect_band_values(plan: RectBandPlan, vals):
    """Scatter entry values into the (T, R, W) band ON DEVICE.

    vals may be a device array (e.g. already-shipped transfer weights);
    the only host->device traffic is the (M,) int32 id/perm vectors.
    One sorted segment-sum dispatch; the dump slot absorbs zeros."""
    segs = plan.tiles * plan.tile * plan.width + 1
    prog = _rect_values_program(int(np.asarray(plan.ids).shape[0]), segs)
    flat = prog(jnp.asarray(vals), jnp.asarray(plan.perm),
                jnp.asarray(plan.ids))
    return flat.reshape(plan.tiles, plan.tile, plan.width)


def rect_band_apply_ref(band, offs, Xp):
    """Windowed-band apply: Y = rect_band @ Xp.

    Xp must already be zero-padded to plan.n_cols_pad rows.  Materialises
    the (T, W, B) window gather, then one batched (R, W) @ (W, B) matmul
    per tile."""
    T, R, W = band.shape
    win = Xp[offs[:, None] + jnp.arange(W)[None, :]]       # (T, W, B)
    Y = jnp.einsum("trw,twb->trb", band, win,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=band.dtype)
    return Y.reshape(T * R, Xp.shape[1])


def band_apply(band, X, coef=None):
    """Y = A @ X via shifted batched dense tile matmuls.

    band: (T, R, W) with W = (2*halo+1)*R; X: (T*R, B).
    coef: optional (B,) per-column scaling fused into the output.

    Formulated as (2*halo+1) batched (R, R) @ (R, B) matmuls over
    tile-shifted copies of X rather than one (T, W, B) window gather:
    the shifted operands are contiguous pad+slice copies, nothing
    larger than X itself is materialised.
    """
    T, R, W = band.shape
    halo = (W // R - 1) // 2
    n, B = X.shape
    Xt = X.reshape(T, R, B).astype(band.dtype)
    Y = None
    for k in range(2 * halo + 1):
        bk = jax.lax.slice_in_dim(band, k * R, (k + 1) * R,
                                  axis=2)                    # (T, R, R)
        s = k - halo
        if s < 0:
            Xs = jnp.concatenate(
                [jnp.zeros((-s, R, B), Xt.dtype), Xt[:T + s]], axis=0)
        elif s > 0:
            Xs = jnp.concatenate(
                [Xt[s:], jnp.zeros((s, R, B), Xt.dtype)], axis=0)
        else:
            Xs = Xt
        Yk = jnp.einsum("trw,twb->trb", bk, Xs,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=Xt.dtype)
        Y = Yk if Y is None else Y + Yk
    Y = Y.astype(X.dtype)
    if coef is not None:
        Y = Y * coef.astype(X.dtype)[None, None, :]
    return Y.reshape(n, B)
