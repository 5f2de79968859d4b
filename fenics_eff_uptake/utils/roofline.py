"""Roofline accounting for the hot solve path.

A static byte/FLOP cost model of one preconditioned-CG iteration (banded
or element operator apply + multigrid V-cycle + vector work), evaluated
against the device's published peak memory bandwidth and f32 rate.
bench.py reports `achieved_hbm_gbps` / `hbm_roofline_pct` / `mfu_pct`
so regressions in how well the solve maps to the hardware are visible,
not just wall-clock.

The model counts the DOMINANT streams only (operator/transfer bands,
coarse inverses, the ~13 (n, B) vector passes of CG+smoothing); it is a
lower bound on true traffic, so the reported achieved-GB/s is itself a
lower bound.

No reference counterpart: the reference ships no performance
accounting at all (SURVEY.md section 6).
"""

from __future__ import annotations

__all__ = ["chip_peaks", "ml_cg_iteration_cost", "roofline_summary",
           "UnknownDeviceError", "PEAKS"]


# Published peaks per device, keyed by jax's device_kind.  The solver's
# f32 products run at HIGHEST precision (no TF32), so "f32_tflops" --
# the rate outside the tensor cores -- is the one the model divides by.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0, "f32_tflops": 67.0, "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM, "
                  "dense rates without sparsity, 700 W",
    },
}


class UnknownDeviceError(LookupError):
    """The device has no row in PEAKS (never a silent default)."""


def chip_peaks(device=None):
    """PEAKS row of the (default) device plus its 'kind'; raises
    UnknownDeviceError for a device kind that is not in the table."""
    import jax
    if device is None:
        device = jax.devices()[0]
    kind = device.device_kind
    if kind not in PEAKS:
        raise UnknownDeviceError(
            f"no published peaks for device_kind {kind!r} "
            f"(utils/roofline.py PEAKS)")
    return dict(PEAKS[kind], kind=kind)


def _band_cost(band_shape, B, dtype_bytes=4):
    """One banded apply Y = band @ X_window: band read once (the
    dominant stream), X/Y vector traffic, 2*T*R*W*B MAC flops."""
    T, R, W = [int(s) for s in band_shape]
    flops = 2.0 * T * R * W * B
    bytes_ = T * R * W * dtype_bytes + 3.0 * T * R * B * dtype_bytes
    return bytes_, flops


def _elem_cost(A_shape, B, dtype_bytes=4):
    """Element-path apply: gather X rows, per-element matmul, scatter.
    A_e read once; X gathered/scattered per element entry."""
    N, nd, _ = [int(s) for s in A_shape]
    flops = 2.0 * N * nd * nd * B
    bytes_ = (N * nd * nd * dtype_bytes        # element matrices
              + 2.0 * N * nd * B * dtype_bytes)  # gathered X + scatter Y
    return bytes_, flops


def ml_cg_iteration_cost(sys_t, ml, B, n_smooth=1, cycle="mult",
                         dtype_bytes=4):
    """Modelled bytes/FLOPs of ONE preconditioned-CG iteration of the
    batched transport solve: one fine operator apply (CG) plus the
    multigrid cycle (2*n_smooth applies per level, banded transfers,
    dense coarse solve) plus ~13 fine (n, B) vector streams (CG axpys,
    dots, smoothing updates).

    sys_t: fine TransportSystem; ml: MultilevelData.  Returns a dict
    with totals and a per-component breakdown.
    """
    parts = {}

    def _apply_cost(sys_l, band):
        if band is not None:
            return _band_cost(band.shape, B, dtype_bytes)
        return _elem_cost(sys_l.K.A64.shape, B, dtype_bytes)

    # CG operator apply at the fine level (f32 banded workhorse)
    by, fl = _apply_cost(sys_t, sys_t.Kband)
    parts["cg_apply"] = (by, fl)

    applies_per_level = 2 * n_smooth  # residual + mirrored post-smooth
    tb_by = tb_fl = lv_by = lv_fl = 0.0
    for il, lev in enumerate(ml.levels):
        s = lev.sys
        aby, afl = _apply_cost(s, s.Kband)
        if cycle == "add" or (cycle == "hybrid" and il == 0):
            # additive cycle: no level applies anywhere; hybrid: the
            # FINE level is additive (scaled Jacobi + coarse term only)
            aby = afl = 0.0
        lv_by += applies_per_level * aby
        lv_fl += applies_per_level * afl
        if lev.bands is not None:
            # transfer bands ride in bf16 when _ml_tb_bf16() is on (the
            # executed program converts them in ml_preconditioner_args)
            from ..solvers.multilevel import _ml_tb_bf16
            tb_bytes = 2 if _ml_tb_bf16() else dtype_bytes
            for bnd in (lev.bands[0], lev.bands[2]):
                b2, f2 = _band_cost(bnd.band.shape, B, tb_bytes)
                tb_by += b2
                tb_fl += f2
        else:
            n_f = int(s.ndofs)
            tb_by += 2 * (3 * n_f * (4 + dtype_bytes)
                          + 3 * n_f * B * dtype_bytes)
            tb_fl += 2 * (2.0 * 3 * n_f * B)
    parts["vcycle_applies"] = (lv_by, lv_fl)
    parts["vcycle_transfers"] = (tb_by, tb_fl)

    nc = int(ml.Ainv.shape[1])
    parts["coarse_dense"] = (B * nc * nc * dtype_bytes,
                             2.0 * B * nc * nc)

    n_fine = int(sys_t.ndofs)
    vec_streams = 13.0
    parts["cg_vectors"] = (vec_streams * n_fine * B * dtype_bytes, 0.0)

    total_bytes = sum(b for b, _ in parts.values())
    total_flops = sum(f for _, f in parts.values())
    return {"bytes_per_iter": total_bytes,
            "flops_per_iter": total_flops,
            "breakdown": {k: {"bytes": b, "flops": f}
                          for k, (b, f) in parts.items()}}


def assembly_cost(sys_t, dtype_bytes=8):
    """Modelled device bytes of ONE warm transport-system assembly:
    quadrature einsum inputs/outputs (coords, tabulation tables, element
    matrices in f64) plus the banded-form scatter (band written once,
    element values + column ids read once).  Host-side work (dofmap,
    plan loads, numpy glue) is NOT modelled -- the gap between this
    bound and the measured wall-clock is host and dispatch time.
    """
    N, nd, _ = [int(s) for s in sys_t.K.A64.shape]
    by = (N * 3 * 2 * dtype_bytes          # cell coords
          + 2 * N * nd * nd * dtype_bytes  # element matrices out (K, M)
          + N * nd * nd * dtype_bytes)     # robin/aux block
    if sys_t.Kband is not None:
        T, R, W = [int(s) for s in sys_t.Kband.shape]
        by += T * R * W * 4                # band written (f32)
        by += N * nd * nd * (4 + 4)        # values + flat ids read
    return {"bytes": by}


def roofline_summary(cost, iters_executed, wall_s, passes_f64=0,
                     sys_t=None, B=1, peaks=None):
    """Achieved GB/s / TFLOPs vs chip peaks for a measured solve.

    cost: ml_cg_iteration_cost output; iters_executed: executed CG
    iterations (max over the batch -- every column does the work while
    any is active); wall_s: measured solve wall-clock; passes_f64:
    outer defect-correction passes (each one f64 element apply, modelled
    at 2x f32 element bytes).
    """
    if peaks is None:
        peaks = chip_peaks()
    total_bytes = cost["bytes_per_iter"] * iters_executed
    total_flops = cost["flops_per_iter"] * iters_executed
    if passes_f64 and sys_t is not None:
        b64, f64_fl = _elem_cost(sys_t.K.A64.shape, B, dtype_bytes=8)
        total_bytes += passes_f64 * b64
        total_flops += passes_f64 * f64_fl
    gbps = total_bytes / max(wall_s, 1e-12) / 1e9
    tflops = total_flops / max(wall_s, 1e-12) / 1e12
    return {
        "chip": peaks["kind"],
        "modeled_bytes_per_iter_mb": round(
            cost["bytes_per_iter"] / 2**20, 2),
        "achieved_hbm_gbps": round(gbps, 1),
        "hbm_roofline_pct": round(100.0 * gbps / peaks["hbm_gbps"], 1),
        "achieved_tflops": round(tflops, 2),
        "mfu_pct": round(100.0 * tflops / peaks["f32_tflops"], 1),
        "peak_hbm_gbps": peaks["hbm_gbps"],
        "peak_f32_tflops": peaks["f32_tflops"],
    }
