"""Compare a sharded study CSV against the committed artifact.

Gate for the multichip punch-list item: a study run with `--shard N`
(ALL solves executed under shard_map on an N-device mesh,
parallel/sharded_solve.py) must reproduce the committed single-chip
artifact to <= 1e-8 relative on every metric column.  Reference
analogue: the latent MPI capability scoped in SURVEY.md section 2.3
(the FEniCS original runs serially).

Usage:
    python -m fenics_eff_uptake.studies.phase_b run --shard 8 --tp 2 \
        --output-base /tmp/pb_shard_full
    python scripts/compare_sharded_study.py /tmp/pb_shard_full

    python -m fenics_eff_uptake.studies.adv_diff run --shard 8 \
        --tp 2 --output-base /tmp/ad_shard_full
    python scripts/compare_sharded_study.py /tmp/ad_shard_full advdiff
"""
import json
import os
import sys

import numpy as np
import pandas as pd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8

STUDIES = {
    "phase_b": {
        "csv_rel": os.path.join("mu Sweep Analysis",
                                "no_adv_mu_sweep_results.csv"),
        "committed": os.path.join(REPO, "examples", "phase_b_h0.02",
                                  "mu Sweep Analysis",
                                  "no_adv_mu_sweep_results.csv"),
        "keys": ["geometry", "mu_factor"],
        "metrics": ["avg_conc_sulc", "avg_conc_rect", "flux_sulc_y0",
                    "flux_rect_bottom", "CR", "flux_ratio"],
        # denominator floors for difference-of-differences columns
        "floors": {},
    },
    "advdiff": {
        "csv_rel": os.path.join("Results Data",
                                "advdiff_validation_step_pe_x_mu.csv"),
        "committed": os.path.join(REPO, "examples", "advdiff_h0.02",
                                  "Results Data",
                                  "advdiff_validation_step_pe_x_mu.csv"),
        "keys": ["Pe", "mu_factor", "domain_type"],
        "metrics": ["total_flux", "diffusive_flux", "advective_flux",
                    "uptake_flux", "avg_conc", "CR", "mu_eff_open",
                    "mu_eff_sim", "flux_ratio", "flux_error_pct"],
        # two columns are near-zero differences whose natural scale is
        # NOT their own value: the advective flux component vanishes at
        # Pe=0.1 (gate vs the total-flux scale, min |total_flux| =
        # 0.45), and flux_error_pct is a surrogate-minus-reference
        # residual in percent units (gate vs 1%)
        "floors": {"advective_flux": 1e-1, "flux_error_pct": 1.0},
    },
    "no_uptake": {
        "csv_rel": os.path.join("Geometry Comparison Analysis",
                                "geometry_comparison_results.csv"),
        "committed": os.path.join(REPO, "examples", "no_uptake_h0.02",
                                  "Geometry Comparison Analysis",
                                  "geometry_comparison_results.csv"),
        "keys": ["Domain", "Peclet", "Sulcus Width (mm)",
                 "Sulcus Depth (mm)"],
        "metrics": ["Avg Concentration", "Total Mass", "Mouth E_L1",
                    "Mouth_Flux_Total", "Concentration_Ratio"],
        # net mouth flux is ~0 by physics (no uptake): it is Q_in-Q_out,
        # each O(E_L1) ~ 0.1, and the artifact's own "Mouth Net Check"
        # noise on it is ~1e-4 -- gate its delta (measured 1.8e-10 abs)
        # against the O(0.1) exchange scale, not the vanishing value.
        # Micro-mouth E_L1 bottoms out at ~1e-4: same reasoning.
        "floors": {"Mouth_Flux_Total": 1e-1, "Mouth E_L1": 1e-4},
    },
}


def compare(shard_base, study="phase_b", tol=TOL):
    cfg = STUDIES[study]
    s = pd.read_csv(os.path.join(shard_base, cfg["csv_rel"]))
    g = pd.read_csv(cfg["committed"])
    m = s.merge(g, on=cfg["keys"], suffixes=("_sh", "_ref"))
    out = {"study": study, "rows_sharded": len(s),
           "rows_committed": len(g), "rows_matched": len(m), "tol": tol,
           "per_metric": {}}
    worst = 0.0
    for c in cfg["metrics"]:
        if c + "_sh" not in m.columns:
            continue
        a = pd.to_numeric(m[c + "_sh"], errors="coerce").to_numpy(float)
        b = pd.to_numeric(m[c + "_ref"], errors="coerce").to_numpy(float)
        ok = np.isfinite(a) & np.isfinite(b)
        if not ok.any():
            continue
        floor = max(cfg["floors"].get(c, 0.0), 1e-12)
        rel = float(np.max(np.abs(a[ok] - b[ok])
                           / np.maximum(np.abs(b[ok]), floor)))
        out["per_metric"][c] = rel
        worst = max(worst, rel)
    out["max_rel_delta"] = worst
    out["ok"] = bool(len(m) == len(s) and len(m) > 0 and worst <= tol)
    return out


if __name__ == "__main__":
    base = sys.argv[1] if len(sys.argv) > 1 else "/tmp/pb_shard_full"
    study = sys.argv[2] if len(sys.argv) > 2 else "phase_b"
    res = compare(base, study)
    print(json.dumps(res, indent=2))
    sys.exit(0 if res["ok"] else 1)
