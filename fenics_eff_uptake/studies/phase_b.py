"""Phase-B study: no-advection sulcus vs rectangular surrogate comparison.

JAX re-implementation of ``no_advection_analysis_B.py``: for each
mu* in {0.1, 0.5, 1.0} x 23 geometries, run the sulcus AND the rectangular
domain with identical parameters and compare

  CR            = avg_conc_sulcus / avg_conc_rect       (ref :150-153)
  flux_ratio    = flux_rect_bottom / flux_sulc_y0       (ref :154-158)
  flux_error_pct= 100 (flux_r - flux_s)/|flux_s|        (ref :156-158)

CSV schema matches no_adv_mu_sweep_results.csv exactly.  Per geometry the
3 mu values are ONE batched CG solve per domain (46 meshes, 6 batched
solves worth of mu points each -> 138 logical solves as in the reference,
SURVEY.md 3.3).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..params import Parameters, create_geometry_variations
from .common import (create_study_dirs, make_no_adv_params, no_adv_batch,
                     save_csv, save_metadata, use_shard_devices)

__all__ = ["run_no_adv_mu_sweep", "replot_from_csv", "MU_FACTORS"]

MU_FACTORS = [0.1, 0.5, 1.0]
DEFAULT_OUTPUT_BASE = "Results/No Advection Simulations/mu Sweep"
DEFAULT_CSV_NAME = "no_adv_mu_sweep_results.csv"


def _flux_sulc(res):
    pf = (res["flux_metrics"].get("sulcus_specific", {})
          .get("physical_flux", {}))
    for key in ("y0_flux", "y0_combined"):
        if key in pf:
            return pf[key].get("total", np.nan)
    return np.nan


def _flux_rect(res):
    return (res["flux_metrics"].get("physical_flux", {})
            .get("bottom", {}).get("total", np.nan))


def run_no_adv_mu_sweep(output_base=None, mesh_size_dim=0.02,
                        mu_factors=None, geometries=None, verbose=True):
    """The full sulcus-vs-rectangle sweep; returns the CSV rows."""
    if output_base is None:
        output_base = DEFAULT_OUTPUT_BASE
    if mu_factors is None:
        mu_factors = MU_FACTORS
    print("=" * 64 + "\nNO ADVECTION -- mu SWEEP OVER GEOMETRIES\n" + "=" * 64)
    t0 = time.time()
    study_dir, _ = create_study_dirs("mu Sweep", output_base)

    base = Parameters(mode="no-adv")
    configs = create_geometry_variations(base, max_width=1.0)
    if geometries is not None:
        configs = {k: v for k, v in configs.items() if k in geometries}
    print(f"Geometries: {len(configs)}, mu factors: {list(mu_factors)}")

    rows = []
    for gkey, gcfg in configs.items():
        try:
            geom = make_no_adv_params(
                1.0, sulci_w_dim=gcfg["sulci_w_dim"],
                sulci_h_dim=gcfg["sulci_h_dim"],
                mesh_size_dim=mesh_size_dim)
            sulc = no_adv_batch(geom, list(mu_factors), "sulcus",
                                verbose=verbose)
            rect = no_adv_batch(geom, list(mu_factors), "rectangular",
                                verbose=verbose)
            for mu, rs, rr in zip(mu_factors, sulc, rect):
                conc_s = rs["mass_metrics"]["average_concentration"]["total"]
                conc_r = rr["mass_metrics"]["average_concentration"]
                flux_s = _flux_sulc(rs)
                flux_r = _flux_rect(rr)
                CR = (conc_s / conc_r
                      if conc_s is not None and conc_r not in (None, 0)
                      else np.nan)
                if flux_s is None or not np.isfinite(flux_s) or \
                        np.isclose(flux_s, 0.0):
                    flux_ratio = flux_err = np.nan
                else:
                    flux_ratio = flux_r / flux_s
                    denom = abs(flux_s) if not np.isclose(abs(flux_s), 0.0) \
                        else 1.0
                    flux_err = 100.0 * (flux_r - flux_s) / denom
                rows.append({
                    "geometry": gkey,
                    "width_mm": gcfg["sulci_w_dim"],
                    "depth_mm": gcfg["sulci_h_dim"],
                    "aspect_ratio": gcfg.get("aspect_ratio"),
                    "mu_factor": mu,
                    "avg_conc_sulc": conc_s,
                    "avg_conc_rect": conc_r,
                    "flux_sulc_y0": flux_s,
                    "flux_rect_bottom": flux_r,
                    "CR": CR,
                    "flux_ratio": flux_ratio,
                    "flux_error_pct": flux_err,
                })
                if verbose:
                    print(f"  {gkey} mu*={mu}: CR={CR:.4f} "
                          f"flux_ratio={flux_ratio:.4f}")
        except Exception as e:
            print(f"  {gkey} failed: {e}")

    csv_path = os.path.join(study_dir, DEFAULT_CSV_NAME)
    rows = save_csv(rows, csv_path, sort_by=["mu_factor", "geometry"])
    p0 = Parameters(mode="no-adv")
    p0.validate()
    p0.nondim()
    save_metadata({
        "study_type": "No Advection -- mu Sweep",
        "mu_factors": list(mu_factors),
        "baselines": {
            "MU_DIM_NO_ADV": Parameters.MU_DIM_NO_ADV,
            "D_dim": p0.D_dim, "H_dim": p0.H_dim, "L_dim": p0.L_dim,
        },
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Phase B sweep done in {time.time() - t0:.1f}s")

    try:
        import pandas as pd
        from ..plotting.phase_b_plots import create_heatmaps
        plots_dir = os.path.join(study_dir, "Plots")
        os.makedirs(plots_dir, exist_ok=True)
        create_heatmaps(pd.read_csv(csv_path), plots_dir)
    except ImportError:
        pass
    return rows


def replot_from_csv(output_base=None):
    """Regenerate heatmaps from a saved CSV (ref :351-391)."""
    import pandas as pd
    if output_base is None:
        output_base = DEFAULT_OUTPUT_BASE
    study_dir = os.path.join(output_base, "mu Sweep Analysis")
    csv_path = os.path.join(study_dir, DEFAULT_CSV_NAME)
    if not os.path.exists(csv_path):
        print(f"No CSV at {csv_path}")
        return None
    df = pd.read_csv(csv_path)
    # recompute derived columns if missing (ref :368-380)
    if "flux_error_pct" not in df.columns and \
            {"flux_rect_bottom", "flux_sulc_y0"} <= set(df.columns):
        denom = df["flux_sulc_y0"].abs().replace(0.0, 1.0)
        df["flux_error_pct"] = 100.0 * (
            df["flux_rect_bottom"] - df["flux_sulc_y0"]) / denom
    from ..plotting.phase_b_plots import create_heatmaps
    plots_dir = os.path.join(study_dir, "Plots")
    os.makedirs(plots_dir, exist_ok=True)
    create_heatmaps(df, plots_dir)
    return df


def main(argv=None):
    # bare-module entry: same f64 + persistent-compile-cache
    # config as the package menu (committed study artifacts
    # are x64; a silent f32 run would look converged but
    # carry ~1e-5 floors)
    from ..utils.jaxconfig import setup
    setup(x64=True)
    import argparse
    ap = argparse.ArgumentParser(description="Phase-B sulcus-vs-rectangle "
                                             "mu sweep")
    ap.add_argument("command", choices=["run", "replot"], nargs="?",
                    default="run")
    ap.add_argument("--mesh-size", type=float, default=0.02)
    ap.add_argument("--output-base", default=None)
    ap.add_argument("--geometries", default=None,
                    help="comma-separated geometry keys (default: all)")
    ap.add_argument("--shard", type=int, default=0, metavar="N",
                    help="run solves sharded over an N-device mesh "
                         "(parallel/sharded_solve.py); needs N devices")
    ap.add_argument("--tp", type=int, default=2,
                    help="cells-partition (tensor-parallel) degree of "
                         "the device mesh; sweep parallelism is N/tp")
    args = ap.parse_args(argv)
    if args.shard:
        use_shard_devices(args.shard, args.tp)
    geoms = (args.geometries.split(",") if args.geometries else None)
    if args.command == "run":
        run_no_adv_mu_sweep(args.output_base, args.mesh_size,
                            geometries=geoms)
    else:
        replot_from_csv(args.output_base)


if __name__ == "__main__":
    main()
