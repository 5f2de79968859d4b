"""Parity tests against the reference's shipped golden values (BASELINE.md).

Two tiers:
  - closed-form quantities (mu_eff^arc, mu_eff^enh) must match the FEniCS
    CSVs to ~1e-12 -- they are mesh-independent;
  - discrete quantities are compared on moderately fine meshes with
    documented discretisation tolerances (the FEniCS goldens were produced
    on h=0.02 Gmsh meshes we deliberately do not bit-copy; h-convergence
    toward the goldens is tracked by studies/mesh_convergence.py -- e.g.
    the mu*=150 ratio converges 0.58 -> 0.74 -> 0.84 -> 0.88 ref).
"""

import numpy as np
import pytest

from fenics_eff_uptake.studies.common import (make_no_adv_params,
                                                  no_adv_batch)


def test_mu_eff_arc_golden():
    """BASELINE.md: mu_eff^arc(w=0.5, h=1.0, L=10) = 1.1594137601849217."""
    from fenics_eff_uptake.analysis.mu_eff import compute_mu_eff_arc

    class P:
        L, sulci_h, sulci_w, mu = 10.0, 1.0, 0.5, 1.0

    assert compute_mu_eff_arc(P) == pytest.approx(1.1594137601849217,
                                                  abs=1e-11)


def test_mu_eff_enh_golden():
    """Phase-A CSV: Mu_Eff_Enhanced = 0.09788675134594813 at mu*=0.1
    (0.5x1.0 sulcus, L=10)."""
    from fenics_eff_uptake.analysis.mu_eff import compute_mu_eff_enh

    class P:
        L, sulci_h, sulci_w, mu = 10.0, 1.0, 0.5, 0.1

    assert compute_mu_eff_enh(P) == pytest.approx(0.09788675134594813,
                                                  abs=1e-14)


def test_mu_eff_sim_vs_golden_moderate_mesh():
    """BASELINE.md: mu_eff^sim = 0.9989350527042656 (0.5x1.0 mm, mu*=1.0,
    h=0.02 FEniCS).  At h=0.06 with our own mesh, agree to ~1%."""
    geom = make_no_adv_params(1.0, sulci_w_dim=0.5, sulci_h_dim=1.0,
                              mesh_size_dim=0.06)
    res = no_adv_batch(geom, [0.1, 1.0], "sulcus", verbose=False)
    golden = {0.1: 0.10730787647090625, 1.0: 0.9989350527042656}
    for mf, r in zip([0.1, 1.0], res):
        sim = r["mu_eff_comparison"]["mu_eff_sim"]
        rel = abs(sim - golden[mf]) / golden[mf]
        assert rel < 0.015, (mf, sim, golden[mf], rel)


def test_phase_b_cr_vs_golden_moderate_mesh():
    """BASELINE.md: Phase-B CR('largest', mu*=0.1) = 0.8757013310084715."""
    from fenics_eff_uptake.studies.phase_b import run_no_adv_mu_sweep
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        rows = run_no_adv_mu_sweep(output_base=td, mesh_size_dim=0.08,
                                   mu_factors=[0.1],
                                   geometries=["largest"], verbose=False)
    cr = rows[0]["CR"]
    assert abs(cr - 0.8757013310084715) < 0.02, cr
    fr = rows[0]["flux_ratio"]
    assert abs(fr - 0.9582400939212387) < 0.02, fr


def test_el1_ladder_certificates_all_agree():
    """Every completed E_L1 refinement-ladder family must certify:
    the FEniCS golden and our h=0.02 value bracket the same
    Richardson limit, with an inter-code delta bounded by the
    discretization error either code still carries (the exact
    statement defended in PARITY.md).  Artifact-gated: reads
    examples/el1_convergence/ladder_*.jsonl summary rows
    (scripts/el1_convergence.py writes them; the printer twin lives
    in scripts/compare_goldens.py el1_certificates)."""
    import glob
    import json
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(
        repo, "examples", "el1_convergence", "ladder_*.jsonl")))
    assert paths, "no ladder artifacts committed"
    checked = 0
    for path in paths:
        with open(path) as fh:
            for line in fh:
                r = json.loads(line)
                if not (r.get("summary") and "extrapolated_E_L1" in r):
                    continue
                g = r.get("golden")
                ge = r.get("golden_err_vs_star")
                oe = r.get("ours_f1_err_vs_star")
                if g is None or ge is None:
                    continue
                e_star = r["extrapolated_E_L1"]
                ours1 = r["ladder"][0][1]
                # golden-converges-onto-OUR-limit (the binding condition
                # is on ge, not the tautological inter-code delta; see
                # scripts/compare_goldens.py el1_row_agrees)
                ok = ge <= 1.25 * oe + 0.01 and ge <= 0.25
                if not ok:
                    # Documented flat-rate exceptions (PARITY.md): the
                    # observed convergence rate is too flat for the
                    # Richardson limit to be trustworthy, so the row is
                    # an honest non-certificate rather than a failure.
                    # Pinned per family+Pe so any NEW non-certifying
                    # row still fails this gate.
                    key = (r.get("w"), r.get("d"), r.get("pe"))
                    rate = r.get("observed_rate_p")
                    flat_ok = (key in {(0.4, 2.0, 0.1)}
                               and rate is not None and rate < 0.2)
                    assert flat_ok, (path, r["pe"], g, ours1, e_star,
                                     ge, oe)
                    continue
                checked += 1
    assert checked >= 10, f"only {checked} certified rows found"
