"""Plotting smoke tests: every figure writer runs and produces files."""

import os

import numpy as np
import pandas as pd
import pytest

from fenics_eff_uptake.meshing.generator import generate_mesh
from fenics_eff_uptake.models.diffusion import pure_diffusion_solve


@pytest.fixture(scope="module")
def sim_results():
    from fenics_eff_uptake.analysis.flux import compute_flux_metrics
    from fenics_eff_uptake.analysis.mass import compute_mass_metrics
    from fenics_eff_uptake.analysis.mu_eff import compute_mu_eff_metrics
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.5,
                       sulcus_width=0.5, mesh_size=0.15,
                       refinement_factor=1, domain_type="sulcus")
    c = pure_diffusion_solve(md, D=1.0, mu=1.0)

    class P:
        L, H = 5.0, 1.0
        sulci_h, sulci_w = 0.5, 0.5
        mu = 1.0
        mode = "no-adv"

    fm = compute_flux_metrics(c, None, md, "sulcus", 1.0, 1.0, warn=False)
    return {
        "c": c, "u": None, "p": None,
        "mesh_results": {"mesh": md},
        "flux_metrics": fm,
        "mass_metrics": compute_mass_metrics(c, md, "sulcus"),
        "mu_eff_comparison": compute_mu_eff_metrics(c, md, P, fm),
        "params": P,
    }


def test_plot_single_simulation(sim_results, tmp_path):
    from fenics_eff_uptake.plotting.single import plot_single_simulation
    plot_single_simulation(sim_results, str(tmp_path))
    pngs = [f for f in os.listdir(tmp_path) if f.endswith(".png")]
    assert len(pngs) >= 7, pngs
    assert "concentration_field.png" in pngs
    assert "mu_eff_methods.png" in pngs


def test_phase_b_heatmaps(tmp_path):
    from fenics_eff_uptake.plotting.phase_b_plots import create_heatmaps
    df = pd.DataFrame({
        "geometry": ["a", "b", "c"] * 2,
        "width_mm": [0.5, 1.0, 0.3] * 2,
        "depth_mm": [0.5, 0.2, 1.0] * 2,
        "mu_factor": [0.1] * 3 + [1.0] * 3,
        "CR": [0.97, 0.99, 0.95, 0.9, 0.93, 0.88],
        "flux_ratio": [0.99, 1.0, 0.97, 0.96, 0.98, 0.94],
        "flux_error_pct": [-1.0, 0.2, -2.5, -3.0, -1.5, -5.0],
    })
    create_heatmaps(df, str(tmp_path))
    pngs = [f for f in os.listdir(tmp_path) if f.endswith(".png")]
    assert len(pngs) == 6


@pytest.mark.slow  # ~12 s of matplotlib rendering; the faster
# create_heatmaps test above keeps adv-diff plotting in the fast gate
def test_advdiff_validation_plots(tmp_path):
    from fenics_eff_uptake.plotting.adv_diff_plots import (
        create_validation_plots)
    rows = []
    for pe in (0.1, 1.0):
        for mf in (0.1, 1.0):
            rows.append({"Pe": pe, "mu_factor": mf,
                         "domain_type": "sulcus",
                         "mu_eff_open": 1.5 * mf, "flux_error_pct": np.nan,
                         "CR": np.nan, "Domain_Length_mm": 10.0,
                         "Sulcus_Width_mm": 0.5})
            rows.append({"Pe": pe, "mu_factor": mf,
                         "domain_type": "rectangular",
                         "mu_eff_open": 1.5 * mf,
                         "flux_error_pct": 0.1 * mf, "CR": 0.97,
                         "Domain_Length_mm": np.nan,
                         "Sulcus_Width_mm": np.nan})
    create_validation_plots(pd.DataFrame(rows), str(tmp_path))
    assert os.path.exists(tmp_path / "validation_heatmaps.png")
    assert os.path.exists(tmp_path / "mu_step_profiles_grid.png")


def test_comparison_and_summary(sim_results, tmp_path):
    from fenics_eff_uptake.plotting.comparison import (
        plot_configuration_comparison, save_summary)
    rd = {"cfg_a": sim_results, "cfg_b": sim_results}
    plot_configuration_comparison(rd, str(tmp_path))
    assert os.path.exists(tmp_path / "compare_total_mass.png")
    # ref plotting.py:778-1090 panel parity (grouped flux / mu_eff /
    # mu_eff-ratio comparisons + in-dir summary JSON)
    assert os.path.exists(tmp_path / "flux_comparison.png")
    assert os.path.exists(tmp_path / "mu_eff_comparison.png")
    assert os.path.exists(tmp_path / "mu_eff_ratios_comparison.png")
    assert os.path.exists(tmp_path / "comparison_summary.json")
    s = save_summary(rd, str(tmp_path / "summary.json"))
    assert s["cfg_a"]["mu_eff_sim"] is not None


def test_comparison_no_uptake_drops_uptake_panels(sim_results, tmp_path):
    """In no-uptake mode the uptake bar and mu_eff panels are omitted
    (ref plotting.py:793,884,922 early returns)."""
    from fenics_eff_uptake.plotting.comparison import (
        plot_flux_comparison, plot_mu_eff_comparison,
        plot_mu_eff_ratios_comparison)

    class PNoU:
        mode = "no-uptake"

    r = dict(sim_results)
    r["params"] = PNoU
    rd = {"cfg": r}
    plot_flux_comparison(rd, str(tmp_path))
    plot_mu_eff_comparison(rd, str(tmp_path))
    plot_mu_eff_ratios_comparison(rd, str(tmp_path))
    assert os.path.exists(tmp_path / "flux_comparison.png")
    assert not os.path.exists(tmp_path / "mu_eff_comparison.png")
    assert not os.path.exists(tmp_path / "mu_eff_ratios_comparison.png")
