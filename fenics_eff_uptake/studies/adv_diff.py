"""Adv-diff step-mu(x) validation -- the flagship study.

JAX re-implementation of ``adv_diff_analysis.py``: the Pe x mu grid
{0.1, 1, 10} x {0.1, 1, 10} with, per cell, (1) a sulcus reference run
extracting mu_eff^open and (2) a rectangular surrogate with the smoothed
step mu(x) = mu_base -> mu_eff^open over the mouth footprint
(ref adv_diff_analysis.py:113-178).  CSV schema matches
advdiff_validation_step_pe_x_mu.csv.

Restructuring (SURVEY.md 3.2: the 9 cells are independent; the
sulcus->rect dependency is per-cell):
  - the nondimensional Stokes velocity is Pe-independent, so each domain
    needs ONE Stokes solve total (the reference runs 18);
  - the 9 sulcus transport solves batch into ONE vmapped BiCGStab
    (Pe enters only through D* = 1/Pe, mu through the Robin block);
  - the 9 rectangular surrogate solves batch the per-cell step-mu Robin
    matrices into a second vmapped solve.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np

from ..params import Parameters, StepUptakeOpen
from ..simulation import get_mesh
from .common import (csv_columns, save_csv, save_metadata,
                     sharded_stokes_or_single as _stokes_for_study,
                     transport_batch as _transport_batch)

__all__ = ["run_advdiff_step_validation", "replot_from_csv",
           "PE_VALUES", "MU_FACTORS", "REFERENCE_GEOMETRY"]

PE_VALUES = [0.1, 1.0, 10]
MU_FACTORS = [0.1, 1.0, 10]
REFERENCE_GEOMETRY = {
    "L_dim": 10.0, "H_dim": 1.0,
    "sulci_w_dim": 0.5, "sulci_h_dim": 1.0,
    "mesh_size_dim": 0.02, "refinement_factor": 1,
}
D_DIM = 0.0003
MU_DIM_BASE = 0.0003
STEP_GAMMA = 5.0


def create_base_parameters(Pe_target, mu_factor, mesh_size_dim=None):
    """Parameters for target Pe and mu factor (ref :74-86)."""
    geo = dict(REFERENCE_GEOMETRY)
    if mesh_size_dim is not None:
        geo["mesh_size_dim"] = mesh_size_dim
    U_ref_dim = Pe_target * D_DIM / geo["H_dim"]
    params = Parameters(mode="adv-diff", U_ref_dim=U_ref_dim, D_dim=D_DIM,
                        **geo)
    params.mu_dim = MU_DIM_BASE * float(mu_factor)
    params.validate()
    params.nondim()
    return params


def _flux_row(flux_metrics, domain_type):
    """Signed flux components (ref :91-107)."""
    if domain_type == "sulcus":
        y0 = (flux_metrics.get("sulcus_specific", {})
              .get("physical_flux", {}).get("y0_flux", {}))
        return {"total_flux": y0.get("total"),
                "diffusive_flux": y0.get("diffusive"),
                "advective_flux": y0.get("advective"),
                "uptake_flux": flux_metrics.get("uptake_flux")}
    bottom = flux_metrics.get("physical_flux", {}).get("bottom", {})
    return {"total_flux": bottom.get("total"),
            "diffusive_flux": bottom.get("diffusive"),
            "advective_flux": bottom.get("advective"),
            "uptake_flux": flux_metrics.get("uptake_flux")}


def run_advdiff_step_validation(
        output_base_dir="Results/AdvDiff Validation (Pe x mu) - Step Only",
        mesh_size_dim=None, pe_values=None, mu_factors=None,
        precision=None, rtol=1e-12, verbose=True):
    """Run the full Pe x mu validation; returns the CSV rows.

    The study metadata records each domain's Stokes and transport solver
    diagnostics (iterations, convergence, relative residuals)."""
    pe_values = list(pe_values or PE_VALUES)
    mu_factors = list(mu_factors or MU_FACTORS)
    print("=" * 64 + "\nADVECTION-DIFFUSION VALIDATION (Step mu only)\n"
          + "=" * 64)
    t0 = time.time()
    results_dir = os.path.join(output_base_dir, "Results Data")
    plots_dir = os.path.join(output_base_dir, "Analysis Plots")
    os.makedirs(results_dir, exist_ok=True)
    os.makedirs(plots_dir, exist_ok=True)

    cells = [(Pe, mf) for Pe in pe_values for mf in mu_factors]

    # ---------------- sulcus reference: 1 mesh, 1 Stokes, 1 batched solve
    p0 = create_base_parameters(pe_values[0], 1.0, mesh_size_dim)
    sulc_mesh = get_mesh(p0, "sulcus")
    t1 = time.time()
    u_s, p_s = _stokes_for_study(sulc_mesh, H=p0.H)
    if verbose:
        print(f"[sulcus] Stokes: {time.time()-t1:.1f}s {u_s.solver_info}")
    D_batch = [1.0 / Pe for Pe, _ in cells]
    mu_batch = [float(mf) for _, mf in cells]
    t1 = time.time()
    Xs, info_s, sys_s = _transport_batch(
        sulc_mesh, u_s, D_batch, mu_batch=mu_batch, rtol=rtol,
        precision=precision)
    if verbose:
        print(f"[sulcus] {len(cells)} transport solves in "
              f"{time.time()-t1:.1f}s "
              f"(iters={np.asarray(info_s['iters']).tolist()})")

    # ONE batched metrics dispatch for all 9 sulcus cells
    # (analysis/batched_metrics.py with advective terms + per-sample D)
    from ..analysis.batched_metrics import (build_sweep_metrics,
                                            metrics_to_dicts)
    import jax.numpy as jnp
    params_s = [create_base_parameters(Pe, mf, mesh_size_dim)
                for (Pe, mf) in cells]
    sm_s = build_sweep_metrics(sys_s.space, sulc_mesh, D=1.0, u=u_s)
    flux_s, mass_s, mueff_s = metrics_to_dicts(
        sm_s, sulc_mesh, jnp.asarray(Xs), mu_batch, 1.0, params_s,
        D_values=D_batch)

    rows = []
    sulc_results: Dict = {}
    for i, (Pe, mf) in enumerate(cells):
        params = params_s[i]
        fm = flux_s[i]
        mm = mass_s[i]
        me = mueff_s[i]
        sulc_results[(Pe, mf)] = {"params": params, "mu_eff": me,
                                  "mass": mm}
        fl = _flux_row(fm, "sulcus")
        rows.append({
            "Pe": Pe, "mu_factor": mf,
            "domain_type": "sulcus", "surrogate_type": "reference",
            **fl,
            "mu_eff_arc": me.get("mu_eff_arc"),
            "mu_eff_sim": me.get("mu_eff_sim"),
            "mu_eff_open": me.get("mu_eff_open"),
            "avg_conc": mm["average_concentration"]["total"],
            "CR": np.nan,
            "Mu_base_nondim": params.mu,
            "Domain_Length_mm": params.L_dim,
            "Sulcus_Width_mm": params.sulci_w_dim,
        })
        if verbose:
            print(f"  sulcus Pe={Pe} mu={mf}: mu_eff_open="
                  f"{me.get('mu_eff_open'):.6f}")

    # ---------------- rectangular surrogates: batched step-mu Robin
    rect_mesh = get_mesh(p0, "rectangular")
    t1 = time.time()
    u_r, p_r = _stokes_for_study(rect_mesh, H=p0.H)
    if verbose:
        print(f"[rect] Stokes: {time.time()-t1:.1f}s {u_r.solver_info}")
    steps = []
    for (Pe, mf) in cells:
        me = sulc_results[(Pe, mf)]["mu_eff"]
        params = sulc_results[(Pe, mf)]["params"]
        xL = params.L / 2 - params.sulci_w / 2
        xR = params.L / 2 + params.sulci_w / 2
        step = StepUptakeOpen(mu_base=float(mf),
                              mu_eff_target=float(me["mu_eff_open"]),
                              sulcus_left_x=xL, sulcus_right_x=xR,
                              L_c=0.1 * params.sulci_w, Gamma=STEP_GAMMA)
        steps.append(step)
    t1 = time.time()
    # the Robin entity-matrix batches are built inside transport_batch
    # so they share the solve system's facet padding
    Xr, info_r, sys_r = _transport_batch(
        rect_mesh, u_r, D_batch, steps=steps,
        rtol=rtol, precision=precision)
    if verbose:
        print(f"[rect] {len(cells)} surrogate solves in "
              f"{time.time()-t1:.1f}s "
              f"(iters={np.asarray(info_r['iters']).tolist()})")

    # ONE batched metrics dispatch for the 9 rect surrogates: the step
    # mu(x) profiles bake in as (B,F,Q) quadrature tables
    params_r = [create_base_parameters(Pe, mf, mesh_size_dim)
                for (Pe, mf) in cells]
    for i, step in enumerate(steps):
        params_r[i].mu = step
        params_r[i].mu_dim = step
    sm_r = build_sweep_metrics(sys_r.space, rect_mesh, D=1.0, u=u_r,
                               mu_profiles=steps)
    flux_r, mass_r, _ = metrics_to_dicts(
        sm_r, rect_mesh, jnp.asarray(Xr), [0.0] * len(cells), 1.0,
        params_r, D_values=D_batch)

    for i, (Pe, mf) in enumerate(cells):
        params = params_r[i]
        fm = flux_r[i]
        mm = mass_r[i]
        me = sulc_results[(Pe, mf)]["mu_eff"]
        avg_s = sulc_results[(Pe, mf)]["mass"][
            "average_concentration"]["total"]
        avg_r = mm["average_concentration"]
        fl = _flux_row(fm, "rectangular")
        rows.append({
            "Pe": Pe, "mu_factor": mf,
            "domain_type": "rectangular", "surrogate_type": "step_open",
            **fl,
            "mu_eff_arc": me.get("mu_eff_arc"),
            "mu_eff_sim": me.get("mu_eff_sim"),
            "mu_eff_open": me.get("mu_eff_open"),
            "avg_conc": avg_r,
            "CR": (avg_s / avg_r
                   if avg_s is not None and avg_r not in (None, 0.0)
                   else np.nan),
        })

    columns = csv_columns(rows) + ["flux_error_pct", "flux_ratio"]
    ref_flux_of = {(r["Pe"], r["mu_factor"]): r["total_flux"]
                   for r in rows if r["domain_type"] == "sulcus"}
    for r in rows:
        r["flux_error_pct"] = r["flux_ratio"] = np.nan
        ref_flux = ref_flux_of.get((r["Pe"], r["mu_factor"]))
        if (r["domain_type"] == "rectangular"
                and r["surrogate_type"] == "step_open"
                and ref_flux is not None):
            denom = ref_flux if ref_flux != 0 else 1.0
            r["flux_ratio"] = r["total_flux"] / denom
            r["flux_error_pct"] = 100.0 * (r["total_flux"] - ref_flux) / (
                abs(ref_flux) if ref_flux != 0 else 1.0)

    csv_path = os.path.join(results_dir,
                            "advdiff_validation_step_pe_x_mu.csv")
    rows = save_csv(rows, csv_path, columns=columns,
                    sort_by=["Pe", "mu_factor", "domain_type"])
    save_metadata({
        "study_type": "AdvDiff Validation (Pe x mu) - Step mu only",
        "Pe_values": pe_values, "mu_factors": mu_factors,
        "reference_geometry": REFERENCE_GEOMETRY,
        "parameters": {"D_dim": D_DIM, "mu_dim_base": MU_DIM_BASE},
        "solvers": {"sulcus": _solver_record(u_s, info_s),
                    "rectangular": _solver_record(u_r, info_r)},
        "elapsed_s": time.time() - t0,
    }, os.path.join(results_dir, "study_metadata.json"))

    try:
        import pandas as pd
        from ..plotting.adv_diff_plots import create_validation_plots
        create_validation_plots(pd.read_csv(csv_path), plots_dir)
    except ImportError:
        pass
    print(f"Adv-diff validation done in {time.time() - t0:.1f}s")
    return rows


def _solver_record(u, info):
    """Stokes and transport solver diagnostics of one domain."""
    rel = np.asarray(info["rel_resnorm"], dtype=float)
    return {"stokes": dict(u.solver_info),
            "transport_iters": np.asarray(info["iters"]).tolist(),
            "transport_max_rel_resnorm": float(rel.max())}


def replot_from_csv(
        output_base_dir="Results/AdvDiff Validation (Pe x mu) - Step Only"):
    import pandas as pd
    csv_path = os.path.join(output_base_dir, "Results Data",
                            "advdiff_validation_step_pe_x_mu.csv")
    if not os.path.exists(csv_path):
        print(f"No CSV at {csv_path}")
        return None
    df = pd.read_csv(csv_path)
    from ..plotting.adv_diff_plots import create_validation_plots
    plots_dir = os.path.join(output_base_dir, "Analysis Plots")
    os.makedirs(plots_dir, exist_ok=True)
    create_validation_plots(df, plots_dir)
    return df


def main(argv=None):
    # bare-module entry: same f64 + persistent-compile-cache
    # config as the package menu (committed study artifacts
    # are x64; a silent f32 run would look converged but
    # carry ~1e-5 floors)
    from ..utils.jaxconfig import setup
    setup(x64=True)
    import argparse
    ap = argparse.ArgumentParser(description="Adv-diff step validation")
    ap.add_argument("command", choices=["run", "replot"], nargs="?",
                    default="run")
    ap.add_argument("--mesh-size", type=float, default=None)
    ap.add_argument("--output-base", default=None)
    ap.add_argument("--shard", type=int, default=0, metavar="N",
                    help="run ALL solves (Stokes saddle, sulcus "
                         "transport, step-mu surrogates) sharded over "
                         "an N-device mesh (parallel/sharded_solve.py);"
                         " needs N devices")
    ap.add_argument("--tp", type=int, default=2,
                    help="cells-partition degree of the device mesh")
    args = ap.parse_args(argv)
    if args.shard:
        from .common import use_shard_devices
        use_shard_devices(args.shard, args.tp)
    base = args.output_base or \
        "Results/AdvDiff Validation (Pe x mu) - Step Only"
    if args.command == "run":
        run_advdiff_step_validation(base, mesh_size_dim=args.mesh_size)
    else:
        replot_from_csv(base)


if __name__ == "__main__":
    main()
