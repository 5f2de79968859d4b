#!/usr/bin/env python
"""Regenerate tests/goldens/self_golden_noadv.json (deliberate refresh).

The self-goldens pin the framework's own end-to-end no-advection outputs
bit-tightly (1e-9 relative, see tests/test_self_golden.py) so refactors
that silently change results are caught.  When a change is *intended*
(e.g. a quadrature-degree bump), re-run this script and commit the diff
together with the change that caused it:

    python scripts/refresh_goldens.py            # writes the file
    python scripts/refresh_goldens.py --check    # exit 1 if stale

Runs on CPU in f64 under the exact configuration the test suite uses
(tests/conftest.py), so the file it writes is what pytest will compare
against.
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GOLDEN = os.path.join(REPO, "tests", "goldens", "self_golden_noadv.json")

META = {
    "geometry": {"w": 0.5, "h": 1.0, "mesh_size": 0.15},
    "mode": "no-adv",
    "element": "P2",
    "rtol": 1e-12,
}
MU_FACTORS = [0.1, 1.0, 10.0]


def compute():
    from fenics_eff_uptake.studies.common import (make_no_adv_params,
                                                      no_adv_batch)
    geom = make_no_adv_params(1.0,
                              sulci_w_dim=META["geometry"]["w"],
                              sulci_h_dim=META["geometry"]["h"],
                              mesh_size_dim=META["geometry"]["mesh_size"])
    res = no_adv_batch(geom, MU_FACTORS, "sulcus", verbose=False)
    values = {}
    for mf, r in zip(MU_FACTORS, res):
        me = r["mu_eff_comparison"]
        mm = r["mass_metrics"]
        pf = r["flux_metrics"]["sulcus_specific"]["physical_flux"]
        values[str(mf)] = {
            "mu_eff_sim": me["mu_eff_sim"],
            "mu_eff_open": me["mu_eff_open"],
            "mu_eff_arc": me["mu_eff_arc"],
            "mu_eff_enh": me["mu_eff_enh"],
            "total_mass": mm["total_mass"],
            "avg_conc_total": mm["average_concentration"]["total"],
            "y0_flux_total": pf["y0_flux"]["total"],
            "mouth_E_L1": pf["sulcus_opening_extra"]["E_L1"],
            "uptake_flux": r["flux_metrics"]["uptake_flux"],
        }
    return {"meta": META, "values": values}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="compare against the committed file; exit 1 if "
                         "any value differs by more than 1e-9 relative")
    args = ap.parse_args()

    fresh = compute()

    if args.check:
        with open(GOLDEN) as f:
            old = json.load(f)
        stale = []
        for mf, want in old["values"].items():
            got = fresh["values"][mf]
            for key, val in want.items():
                ref = max(abs(val), 1e-300)
                if abs(got[key] - val) / ref > 1e-9:
                    stale.append((mf, key, val, got[key]))
        if stale:
            for mf, key, old_v, new_v in stale:
                print(f"STALE mu_factor={mf} {key}: {old_v!r} -> {new_v!r}")
            sys.exit(1)
        print("goldens up to date")
        return

    with open(GOLDEN, "w") as f:
        json.dump(fresh, f, indent=2)
        f.write("\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    main()
