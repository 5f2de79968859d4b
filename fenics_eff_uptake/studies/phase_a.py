"""Phase-A studies: no-advection, sulcus-only mu_eff characterisation.

JAX re-implementation of ``no_advection_analysis_A.py`` (1759 LoC in
the reference): the same four studies with the same CSV schemas, but each
mu sweep on a fixed geometry runs as ONE vmapped batched CG solve.

  1. run_mu_sweep            (ref :1257-1359) -- 20 mu factors, 3 regimes,
                              0.25x0.25 mm sulcus (the reference sets
                              0.05 first at :1265 then overrides to 0.25 at
                              :1313; net geometry is 0.25x0.25).
  2. run_aspect_ratio_analysis (ref :1361-1461) -- depth ladder x AR
                              {1, 2, 0.5}, skip w > 1 mm.
  3. run_geometry_analysis   (ref :1463-1581) -- 23 geometries x mu factors.
  4. run_mu_eff_analysis     (ref :1583-1682) -- 0.5x1.0 mm sulcus x 3 mu,
                              with mu(x) bottom sampling arrays.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..analysis.mu_eff import sample_mu_along_bottom
from ..params import Parameters, create_geometry_variations
from .common import (create_study_dirs, make_no_adv_params, no_adv_batch,
                     save_csv, save_metadata)

__all__ = ["run_mu_sweep", "run_aspect_ratio_analysis",
           "run_geometry_analysis", "run_mu_eff_analysis",
           "replot_from_csv", "MU_SWEEP_REGIMES"]

BASE_DIR = "Results/No Advection Simulations/Phase A"

MU_SWEEP_REGIMES = {
    "small_uptake": [0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 2.5, 3.0],
    "moderate_uptake": [5.0, 7.5, 10.0, 12.5, 15.0],
    "high_uptake": [50.0, 75.0, 100.0, 125.0, 150.0],
}


def _mu_eff_columns(result):
    """Common mu_eff CSV columns (ref no_advection_analysis_A.py:64-91)."""
    row = {}
    me = result.get("mu_eff_comparison")
    if me:
        row.update({
            "Mu_Eff_Simulation": me.get("mu_eff_sim"),
            "Mu_Eff_Analytical": me.get("mu_eff_arc"),
            "Mu_Eff_Enhanced": me.get("mu_eff_enh"),
            "Mu_Eff_Opening": me.get("mu_eff_open"),
        })
        ratios = me.get("ratios", {})
        row.update({
            "Ratio_Sim": ratios.get("sim"),
            "Ratio_Analytical": ratios.get("arc"),
            "Ratio_Enhanced": ratios.get("enh"),
            "Ratio_Opening": ratios.get("open"),
        })
        errs = me.get("errors_vs_sim", {})
        row.update({
            "Relative_Error_Analytical": errs.get("arc"),
            "Relative_Error_Enhanced": errs.get("enh"),
            "Relative_Error_Opening": errs.get("open"),
        })
    row["Total_Mass"] = result.get("mass_metrics", {}).get("total_mass")
    mouth = (result.get("flux_metrics", {}).get("sulcus_specific", {})
             .get("physical_flux", {}).get("sulcus_opening", {}))
    row["Mouth_Flux_Total"] = mouth.get("total")
    return row


def run_mu_sweep(mesh_size_dim=0.02, base_dir=BASE_DIR, verbose=True):
    """mu parameter sweep across three uptake regimes (ref :1257-1359)."""
    print("=" * 60 + "\nMU PARAMETER SWEEP STUDY\n" + "=" * 60)
    t0 = time.time()
    study_dir, _ = create_study_dirs("Mu Parameter Sweep", base_dir)

    factors = [f for regime in MU_SWEEP_REGIMES.values() for f in regime]
    regimes = [name for name, fs in MU_SWEEP_REGIMES.items() for _ in fs]

    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=mesh_size_dim)
    results = no_adv_batch(geom, factors, "sulcus", verbose=verbose)

    rows = []
    for regime, factor, res in zip(regimes, factors, results):
        config_name = f"{regime}_mu_{factor:.1f}x"
        row = {
            "Config": config_name,
            "Regime": regime,
            "Mu_Factor": factor,
            "Mu_dim": res["params"].mu_dim,
            "Mu": res["params"].mu,
            "Baseline_Mu_dim": Parameters.MU_DIM_NO_ADV,
        }
        row.update(_mu_eff_columns(res))
        rows.append(row)
    rows = save_csv(rows, os.path.join(study_dir,
                                       "mu_parameter_sweep_results.csv"))
    save_metadata({
        "study_type": "Mu Parameter Sweep",
        "regimes": MU_SWEEP_REGIMES,
        "geometry_mm": [0.25, 0.25],
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Mu sweep done in {time.time() - t0:.1f}s")
    return rows


def aspect_ratio_depths():
    """Depth ladder (ref :1366-1371)."""
    micro = np.logspace(np.log10(0.01), np.log10(0.10), 10)
    meso = np.array([0.12, 0.15, 0.20, 0.25, 0.35, 0.50, 0.75, 1.00])
    macro = np.array([1.50, 2.00, 2.50, 3.00, 3.50, 4.00, 4.50, 5.00])
    return sorted(set(np.round(np.concatenate([micro, meso, macro]), 4)))


ASPECT_RATIOS = {"h_equals_w": 1.0, "h_equals_2w": 2.0,
                 "h_equals_half_w": 0.5}


def run_aspect_ratio_analysis(mesh_size_dim=0.02, base_dir=BASE_DIR,
                              depths=None, verbose=True):
    """Aspect-ratio study: mu_eff/mu vs depth (ref :1361-1461)."""
    print("=" * 60 + "\nASPECT RATIO ANALYSIS\n" + "=" * 60)
    t0 = time.time()
    study_dir, _ = create_study_dirs("Aspect Ratio Study", base_dir)
    if depths is None:
        depths = aspect_ratio_depths()

    rows = []
    for ar_name, ar_value in ASPECT_RATIOS.items():
        for h in depths:
            w = h / ar_value
            if w > 1.0:
                continue
            config_name = f"{ar_name}_h{h}"
            try:
                geom = make_no_adv_params(1.0, sulci_w_dim=w, sulci_h_dim=h,
                                          mesh_size_dim=mesh_size_dim)
                res = no_adv_batch(geom, [1.0], "sulcus",
                                   verbose=verbose)[0]
                row = {
                    "Config": config_name,
                    "Aspect_Ratio_Type": ar_name,
                    "Width": w,
                    "Depth": h,
                    "Aspect_Ratio": ar_value,
                }
                row.update(_mu_eff_columns(res))
                rows.append(row)
            except Exception as e:
                print(f"  {config_name} failed: {e}")
    rows = save_csv(rows, os.path.join(study_dir,
                                       "aspect_ratio_analysis_results.csv"))
    save_metadata({
        "study_type": "Aspect Ratio Study",
        "aspect_ratios": ASPECT_RATIOS,
        "n_depths": len(depths),
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Aspect ratio study done in {time.time() - t0:.1f}s")
    return rows


def run_geometry_analysis(mu_factors=(0.1, 1.0, 10), mesh_size_dim=0.02,
                          base_dir=BASE_DIR, geometries=None, verbose=True):
    """Geometry analysis: 23 geometries x mu factors (ref :1463-1581)."""
    print("=" * 60 + "\nGEOMETRY ANALYSIS STUDY\n" + "=" * 60)
    t0 = time.time()
    study_dir, _ = create_study_dirs("Geometry Analysis", base_dir)
    base = Parameters(mode="no-adv")
    configs = create_geometry_variations(base, max_width=1.0)
    if geometries is not None:
        configs = {k: v for k, v in configs.items() if k in geometries}

    rows = []
    for gkey, gcfg in configs.items():
        try:
            geom = make_no_adv_params(
                1.0, sulci_w_dim=gcfg["sulci_w_dim"],
                sulci_h_dim=gcfg["sulci_h_dim"],
                mesh_size_dim=mesh_size_dim)
            results = no_adv_batch(geom, list(mu_factors), "sulcus",
                                   verbose=verbose)
            for factor, res in zip(mu_factors, results):
                config_name = f"{gkey}_mu_{factor}x"
                row = {
                    "Config": config_name,
                    "Geometry_Name": gkey,
                    "Mu_Value": res["params"].mu_dim,
                    "Mu_Factor": factor,
                    "Sulcus_Width_mm": gcfg["sulci_w_dim"],
                    "Sulcus_Depth_mm": gcfg["sulci_h_dim"],
                    "Aspect_Ratio": (gcfg["sulci_h_dim"] / gcfg["sulci_w_dim"]
                                     if gcfg["sulci_w_dim"] > 0 else None),
                    "Aspect_Ratio_Category": gcfg.get(
                        "aspect_ratio_category", "unknown"),
                }
                row.update(_mu_eff_columns(res))
                rows.append(row)
        except Exception as e:
            print(f"  {gkey} failed: {e}")
    rows = save_csv(rows, os.path.join(study_dir,
                                       "geometry_analysis_results.csv"))
    save_metadata({
        "study_type": "Geometry Analysis",
        "mu_factors": list(mu_factors),
        "n_geometries": len(configs),
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Geometry analysis done in {time.time() - t0:.1f}s")
    return rows


def run_mu_eff_analysis(mu_factors=(0.1, 1.0, 10.0), mesh_size_dim=0.02,
                        base_dir=BASE_DIR, verbose=True):
    """mu_eff spatial analysis on the 0.5x1.0 mm sulcus (ref :1583-1682)."""
    print("=" * 60 + "\nMU_EFF SPATIAL ANALYSIS\n" + "=" * 60)
    t0 = time.time()
    study_dir, _ = create_study_dirs("Mu_Eff Spatial Analysis", base_dir)

    geom = make_no_adv_params(1.0, sulci_w_dim=0.5, sulci_h_dim=1.0,
                              mesh_size_dim=mesh_size_dim)
    results = no_adv_batch(geom, list(mu_factors), "sulcus", verbose=verbose)

    rows = []
    for factor, res in zip(mu_factors, results):
        config_name = f"mu_eff_analysis_mu_{factor}x"
        p = res["params"]
        row = {
            "Config": config_name,
            "Mu_Value": p.mu_dim,
            "Mu_Factor": factor,
            "Sulcus_Width_mm": p.sulci_w_dim,
            "Sulcus_Depth_mm": p.sulci_h_dim,
            "Domain_Length_mm": p.L_dim,
            "L_ref": p.L_ref,
            "L_nondim": p.L,
            "H_nondim": p.H,
            "Sulcus_W_nondim": p.sulci_w,
            "Sulcus_H_nondim": p.sulci_h,
            "Mu_base_nondim": p.mu,
        }
        me = res.get("mu_eff_comparison", {})
        row.update({
            "Mu_Eff_Simulation": me.get("mu_eff_sim"),
            "Mu_Eff_Analytical": me.get("mu_eff_arc"),
            "Mu_Eff_Enhanced": me.get("mu_eff_enh"),
            "Mu_Eff_Opening": me.get("mu_eff_open"),
        })
        ratios = me.get("ratios", {})
        row.update({
            "Ratio_Sim": ratios.get("sim"),
            "Ratio_Analytical": ratios.get("arc"),
            "Ratio_Enhanced": ratios.get("enh"),
            "Ratio_Opening": ratios.get("open"),
        })
        mu_sample = sample_mu_along_bottom(
            p, res["mesh_results"]["mesh"], n_points=100)
        row.update({
            "Mu_Mean_Bottom": mu_sample["mu_mean"],
            "Mu_Min_Bottom": mu_sample["mu_min"],
            "Mu_Max_Bottom": mu_sample["mu_max"],
            "Mu_X_Array": str(mu_sample["x"].tolist()),
            "Mu_Values_Array": str(mu_sample["mu"].tolist()),
        })
        rows.append(row)
    rows = save_csv(rows, os.path.join(study_dir,
                                       "mu_eff_analysis_results.csv"))
    save_metadata({
        "study_type": "Mu_Eff Spatial Analysis",
        "mu_factors": list(mu_factors),
        "geometry_mm": [0.5, 1.0],
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Mu_eff analysis done in {time.time() - t0:.1f}s")
    return rows


def replot_from_csv(base_dir=BASE_DIR):
    """Regenerate Phase-A figures from saved CSVs (ref :1684-1717)."""
    from glob import glob
    from ..plotting.phase_a_plots import plot_phase_a_csv
    csvs = glob(os.path.join(base_dir, "**", "*.csv"), recursive=True)
    if not csvs:
        print("No CSV files found.")
        return []
    done = []
    for path in csvs:
        try:
            plot_phase_a_csv(path)
            done.append(path)
        except Exception as e:
            print(f"  replot failed for {path}: {e}")
    return done


def main(argv=None):
    # bare-module entry: same f64 + persistent-compile-cache
    # config as the package menu (committed study artifacts
    # are x64; a silent f32 run would look converged but
    # carry ~1e-5 floors)
    from ..utils.jaxconfig import setup
    setup(x64=True)
    import argparse
    ap = argparse.ArgumentParser(
        description="Phase-A no-advection studies (non-interactive CLI "
                    "replacing the reference's stdin menu)")
    ap.add_argument("study", choices=["mu-sweep", "aspect-ratio",
                                      "geometry", "mu-eff", "all",
                                      "replot"])
    ap.add_argument("--mesh-size", type=float, default=0.02)
    ap.add_argument("--base-dir", default=BASE_DIR)
    args = ap.parse_args(argv)
    if args.study in ("mu-sweep", "all"):
        run_mu_sweep(args.mesh_size, args.base_dir)
    if args.study in ("aspect-ratio", "all"):
        run_aspect_ratio_analysis(args.mesh_size, args.base_dir)
    if args.study in ("geometry", "all"):
        run_geometry_analysis(mesh_size_dim=args.mesh_size,
                              base_dir=args.base_dir)
    if args.study in ("mu-eff", "all"):
        run_mu_eff_analysis(mesh_size_dim=args.mesh_size,
                            base_dir=args.base_dir)
    if args.study == "replot":
        replot_from_csv(args.base_dir)


if __name__ == "__main__":
    main()
