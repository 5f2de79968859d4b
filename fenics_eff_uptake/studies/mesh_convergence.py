"""Mesh-convergence (refinement ladder) study.

The reference's readme advertises a ``mesh_analysis.py`` that does not exist
in the snapshot (SURVEY.md section 1 note; the capability is named in
BASELINE.json config #5).  This driver provides it: run the reference
configuration across an h-refinement ladder, track the mu_eff estimators
and key fluxes, estimate convergence orders and Richardson-extrapolated
limits, and write a CSV + convergence plot.

This is also the framework's parity instrument: the FEniCS goldens were
produced on Gmsh meshes we cannot bit-reproduce, so agreement with
BASELINE.md values is demonstrated through the h->0 limit.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..params import Parameters
from .common import (create_study_dirs, make_no_adv_params, no_adv_batch,
                     save_csv, save_metadata)

__all__ = ["run_mesh_convergence", "richardson"]

BASE_DIR = "Results/Mesh Convergence"
DEFAULT_LADDER = [0.08, 0.057, 0.04, 0.028, 0.02]


def richardson(h, q):
    """Estimated order + extrapolated limit from the last 3 ladder points.

    Assumes q(h) ~ q0 + C h^p on a (roughly) geometric ladder
    h1 > h2 > h3: then r = (q2-q1)/(q3-q2) = ((h1^p - h2^p)/(h2^p - h3^p)),
    which for h1/h2 = h2/h3 = s reduces to r = s^p, giving
    p = log r / log s and q0 = q3 + (q3 - q2)/(r - 1).
    Returns (None, q_finest) when the differences are not monotone.
    """
    h = np.asarray(h, dtype=float)
    q = np.asarray(q, dtype=float)
    if len(q) < 3:
        return None, (float(q[-1]) if len(q) else None)
    h1, h2, h3 = h[-3:]
    q1, q2, q3 = q[-3:]
    d12, d23 = q2 - q1, q3 - q2
    if d23 == 0 or d12 / d23 <= 0 or d12 / d23 == 1.0:
        return None, float(q3)
    r = d12 / d23
    s = np.sqrt((h1 / h3))          # effective geometric step ratio
    p_est = float(np.log(r) / np.log(s))
    q0 = float(q3 + d23 / (r - 1.0))
    return p_est, q0


def run_mesh_convergence(mu_factors=(0.1, 1.0, 10.0), ladder=None,
                        sulci_w_dim=0.5, sulci_h_dim=1.0,
                        base_dir=BASE_DIR, verbose=True,
                        realisation_check=False):
    """Refinement ladder on the reference 0.5x1.0 mm sulcus geometry.

    realisation_check=True additionally runs a second, independently
    generated mesh at h ~= the finest ladder point (h*1.005) and records
    the per-quantity deltas -- the MESH-REALISATION FLOOR: the FEniCS
    goldens were produced on Gmsh meshes we cannot bit-reproduce, so no
    comparison can beat this floor (PARITY.md methodology)."""
    print("=" * 60 + "\nMESH CONVERGENCE (refinement ladder)\n" + "=" * 60)
    t0 = time.time()
    if ladder is None:
        ladder = DEFAULT_LADDER
    study_dir, _ = create_study_dirs("Mesh Convergence", base_dir)

    rows = []
    for h in ladder:
        geom = make_no_adv_params(1.0, sulci_w_dim=sulci_w_dim,
                                  sulci_h_dim=sulci_h_dim,
                                  mesh_size_dim=h)
        results = no_adv_batch(geom, list(mu_factors), "sulcus",
                               verbose=verbose)
        for mf, res in zip(mu_factors, results):
            me = res["mu_eff_comparison"]
            info = res["mesh_results"]["mesh_info"]
            pf = (res["flux_metrics"]["sulcus_specific"]["physical_flux"])
            rows.append({
                "mesh_size": h,
                "mu_factor": mf,
                "num_cells": info["num_cells"],
                "num_vertices": info["num_vertices"],
                "hmin": info["hmin"], "hmax": info["hmax"],
                "mu_eff_sim": me["mu_eff_sim"],
                "mu_eff_open": me["mu_eff_open"],
                "mu_eff_arc": me["mu_eff_arc"],
                "mu_eff_enh": me["mu_eff_enh"],
                "ratio_sim": me["ratios"]["sim"],
                "y0_flux": pf["y0_flux"]["total"],
                "total_mass": res["mass_metrics"]["total_mass"],
            })
            if verbose:
                print(f"  h={h} mu*={mf}: mu_eff_sim={me['mu_eff_sim']:.8f}")

    rows = save_csv(rows, os.path.join(study_dir,
                                       "mesh_convergence_results.csv"),
                    sort_by=["mu_factor", "mesh_size"])

    # convergence estimates per mu
    conv = {}
    for mf in mu_factors:
        sub = sorted((r for r in rows if r["mu_factor"] == mf),
                     key=lambda r: -r["mesh_size"])
        p_est, q0 = richardson(np.array([r["mesh_size"] for r in sub]),
                               np.array([r["mu_eff_sim"] for r in sub]))
        conv[str(mf)] = {"order_estimate": p_est,
                         "mu_eff_sim_extrapolated": q0}
        if verbose:
            print(f"  mu*={mf}: order~{p_est}, "
                  f"extrapolated mu_eff_sim={q0}")
    floor = None
    if realisation_check:
        h_f = ladder[-1]
        geom_b = make_no_adv_params(1.0, sulci_w_dim=sulci_w_dim,
                                    sulci_h_dim=sulci_h_dim,
                                    mesh_size_dim=h_f * 1.005)
        res_b = no_adv_batch(geom_b, list(mu_factors), "sulcus",
                             verbose=verbose)
        floor = {}
        for mf, rb in zip(mu_factors, res_b):
            sub = [r for r in rows
                   if r["mu_factor"] == mf and r["mesh_size"] == h_f]
            if not sub:
                continue
            sa = sub[0]
            meb = rb["mu_eff_comparison"]
            pfb = rb["flux_metrics"]["sulcus_specific"]["physical_flux"]
            floor[str(mf)] = {
                "mu_eff_sim_rel": abs(meb["mu_eff_sim"]
                                      - sa["mu_eff_sim"])
                / abs(sa["mu_eff_sim"]),
                "y0_flux_rel": abs(pfb["y0_flux"]["total"]
                                   - sa["y0_flux"])
                / abs(sa["y0_flux"]),
                "total_mass_rel": abs(
                    rb["mass_metrics"]["total_mass"]
                    - sa["total_mass"]) / abs(sa["total_mass"]),
            }
            if verbose:
                print(f"  realisation floor mu*={mf}: "
                      f"{floor[str(mf)]}")

    save_metadata({
        "study_type": "Mesh Convergence",
        "ladder": list(ladder),
        "mu_factors": list(mu_factors),
        "geometry_mm": [sulci_w_dim, sulci_h_dim],
        "convergence": conv,
        "mesh_realisation_floor": floor,
        "elapsed_s": time.time() - t0,
    }, os.path.join(study_dir, "study_metadata.json"))

    try:
        from ..plotting.style import safe_plot
        with safe_plot(os.path.join(study_dir,
                                    "convergence_mu_eff")) as (fig, ax):
            for mf in mu_factors:
                sub = sorted((r for r in rows if r["mu_factor"] == mf),
                             key=lambda r: r["mesh_size"])
                hs = np.array([r["mesh_size"] for r in sub])
                sims = np.array([r["mu_eff_sim"] for r in sub])
                ax.loglog(hs, np.abs(sims - sims[0]) + 1e-16,
                          "o-", label=f"mu*={mf}")
            ax.set_xlabel("mesh size h")
            ax.set_ylabel(r"|mu_eff^sim(h) - mu_eff^sim(h_min)|")
            ax.legend()
    except Exception:
        pass
    print(f"Mesh convergence done in {time.time() - t0:.1f}s")
    return rows


def main(argv=None):
    # bare-module entry: same f64 + persistent-compile-cache
    # config as the package menu (committed study artifacts
    # are x64; a silent f32 run would look converged but
    # carry ~1e-5 floors)
    from ..utils.jaxconfig import setup
    setup(x64=True)
    import argparse
    ap = argparse.ArgumentParser(description="Mesh convergence ladder")
    ap.add_argument("--coarse", action="store_true",
                    help="coarser/faster ladder")
    args = ap.parse_args(argv)
    ladder = [0.16, 0.11, 0.08] if args.coarse else None
    run_mesh_convergence(ladder=ladder)


if __name__ == "__main__":
    main()
