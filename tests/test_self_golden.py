"""Self-regression goldens: guard the full pipeline against refactor drift.

The FEniCS goldens live at mesh resolutions we compare against with
discretisation tolerances (tests/test_parity.py); these SELF-goldens pin
our own end-to-end outputs bit-tightly (1e-9 relative) so future solver /
assembly / mesher changes that alter results are caught immediately.
Regenerate deliberately with /tmp-style scripts if a change is intended.
"""

import json
import os

import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "self_golden_noadv.json")


def test_self_golden_noadv():
    from fenics_eff_uptake.studies.common import (make_no_adv_params,
                                                      no_adv_batch)
    with open(GOLDEN) as f:
        g = json.load(f)
    meta = g["meta"]
    geom = make_no_adv_params(1.0,
                              sulci_w_dim=meta["geometry"]["w"],
                              sulci_h_dim=meta["geometry"]["h"],
                              mesh_size_dim=meta["geometry"]["mesh_size"])
    res = no_adv_batch(geom, [0.1, 1.0, 10.0], "sulcus", verbose=False)
    for mf, r in zip([0.1, 1.0, 10.0], res):
        want = g["values"][str(mf)]
        me = r["mu_eff_comparison"]
        mm = r["mass_metrics"]
        pf = r["flux_metrics"]["sulcus_specific"]["physical_flux"]
        got = {
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
        for key, val in want.items():
            assert got[key] == pytest.approx(val, rel=1e-9), (mf, key)
