"""Analysis-layer tests: fluxes, mass, mu_eff, point evaluation.

Promotes the reference's inline consistency checks (SURVEY.md section 4:
flux identities, Robin consistency, maximum principle) to assertions.
"""

import numpy as np
import pytest

from fenics_eff_uptake.analysis.flux import (compute_flux_metrics,
                                                 compute_uptake_flux_bottom)
from fenics_eff_uptake.analysis.mass import compute_mass_metrics
from fenics_eff_uptake.analysis.mu_eff import (compute_mu_eff_metrics,
                                                   sulcus_arc_length)
from fenics_eff_uptake.analysis.profiles import (PointLocator,
                                                     compute_conc_profiles,
                                                     eval_function)
from fenics_eff_uptake.meshing.generator import (generate_mesh,
                                                     structured_rectangle)
from fenics_eff_uptake.models.diffusion import pure_diffusion_solve


@pytest.fixture(scope="module")
def sulcus_solution():
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=1.0,
                       sulcus_width=0.5, mesh_size=0.08,
                       refinement_factor=1, domain_type="sulcus")
    c = pure_diffusion_solve(md, D=1.0, mu=1.0, element="P2")
    return md, c


def test_linear_solution_fluxes():
    md = structured_rectangle(2.0, 1.0, 16, 8)
    c = pure_diffusion_solve(md, D=1.0, mu=0.0, element="P2")
    fm = compute_flux_metrics(c, None, md, "rectangular", D=1.0, mu=0.0)
    pf = fm["physical_flux"]
    # c = 1 - x/2: left flux = -D * dc/dx * n_x = -0.5; right = +0.5
    assert abs(pf["left"]["total"] + 0.5) < 1e-10
    assert abs(pf["right"]["total"] - 0.5) < 1e-10
    assert abs(pf["top"]["total"]) < 1e-12
    assert abs(pf["bottom"]["total"]) < 1e-12
    assert abs(fm["uptake_flux"]) < 1e-14


def test_mass_metrics_rectangle():
    md = structured_rectangle(2.0, 1.0, 8, 4)
    c = pure_diffusion_solve(md, D=1.0, mu=0.0, element="P1")
    mm = compute_mass_metrics(c, md, "rectangular")
    assert abs(mm["total_area"] - 2.0) < 1e-12
    # int (1 - x/2) over [0,2]x[0,1] = 1
    assert abs(mm["total_mass"] - 1.0) < 1e-12
    assert abs(mm["average_concentration"] - 0.5) < 1e-12


def test_sulcus_flux_identities(sulcus_solution):
    md, c = sulcus_solution
    assert c.solver_info["converged"]
    # maximum principle: 0 <= c <= 1 (+tiny tolerance)
    vals = c.as_numpy()
    assert vals.min() > -1e-10 and vals.max() < 1.0 + 1e-10
    fm = compute_flux_metrics(c, None, md, "sulcus", D=1.0, mu=1.0,
                              warn=False)
    sf = fm["sulcus_specific"]["physical_flux"]
    # conservation in the cavity: flux crossing the y0 line (flat exterior +
    # mouth) = flux leaving through the whole bottom wall (marker 4).
    # (bottom_combined = markers 5+6+7 intentionally misses the 4
    # corner-adjacent facets, matching reference marker semantics.)
    y0 = sf["y0_flux"]["total"]
    bot4 = fm["physical_flux"]["bottom"]["total"]
    assert abs(y0 - bot4) < 0.02 * abs(bot4) + 1e-6, (y0, bot4)
    gap = sf["_y0_identity_gap"]
    assert gap < 0.05 * abs(y0)  # corner-facet gap is small but nonzero
    # Robin consistency: physical bottom flux ~ uptake integral mu*c
    phys_bottom = fm["physical_flux"]["bottom"]["total"]
    uptake = fm["uptake_flux"]
    assert abs(phys_bottom - uptake) < 0.02 * abs(uptake) + 1e-6
    # exchange metrics
    extra = sf["sulcus_opening_extra"]
    net = sf["sulcus_opening"]["total"]
    assert extra["E_L1"] >= abs(net) - 1e-12
    assert abs(extra["net_check"] - net) < 1e-9
    assert abs(extra["length"] - 0.5) < 1e-9
    # pure diffusion: no advective flux anywhere
    assert sf["y0_flux"]["advective"] == 0.0


def test_mu_eff_engine(sulcus_solution):
    md, c = sulcus_solution

    class P:
        L, H = 5.0, 1.0
        sulci_h, sulci_w = 1.0, 0.5
        mu = 1.0
        mode = "no-adv"

    fm = compute_flux_metrics(c, None, md, "sulcus", D=1.0, mu=1.0,
                              warn=False)
    me = compute_mu_eff_metrics(c, md, P, fm)
    # arc length vs scipy quad
    from scipy.integrate import quad
    w, h = 0.5, 1.0
    integral, _ = quad(lambda u: np.sqrt(1 + (np.pi * h / w
                                              * np.cos(np.pi * u)) ** 2),
                       0, 1, epsabs=1e-12, epsrel=1e-12, limit=200)
    assert abs(sulcus_arc_length(w, h) - w * integral) < 1e-10
    assert abs(me["mu_eff_arc"] - 1.0 * (1 + (w * integral - w) / 5.0)) < 1e-10
    # enh closed form
    assert abs(me["mu_eff_enh"]
               - (1.0 * ((5 - 0.5) / 5 + (0.5 / 5)
                         / np.sqrt(1 + 10 * 1 * 1 / 0.5)))) < 1e-12
    # sim/open present and physically sensible (positive, O(mu))
    assert me["mu_eff_sim"] is not None and 0.1 < me["mu_eff_sim"] < 10
    assert me["mu_eff_open"] is not None and me["mu_eff_open"] > 0
    assert me["ratios"]["sim"] == pytest.approx(me["mu_eff_sim"], rel=1e-12)
    aud = me["audit"]
    assert aud["lengths"]["L_mouth"] == pytest.approx(0.5, abs=1e-9)


def test_point_eval_exact_linear():
    md = structured_rectangle(2.0, 1.0, 8, 4)
    c = pure_diffusion_solve(md, D=1.0, mu=0.0, element="P2")
    rng = np.random.RandomState(3)
    pts = rng.rand(50, 2) * [2.0, 1.0]
    vals, valid = eval_function(c, pts)
    assert valid.all()
    assert np.allclose(vals, 1 - pts[:, 0] / 2.0, atol=1e-10)
    # outside points flagged invalid
    _, v2 = eval_function(c, np.array([[2.5, 0.5], [-0.1, 0.2]]))
    assert not v2.any()


def test_conc_profiles_structure(sulcus_solution):
    md, c = sulcus_solution

    class P:
        L, H = 5.0, 1.0
        sulci_h, sulci_w = 1.0, 0.5

    prof = compute_conc_profiles(c, md, P, "sulcus", n_points=100)
    assert "sulcus_mid" in prof["profiles"]["horizontal"]
    assert "x_mid" in prof["profiles"]["vertical"]
    mid = prof["profiles"]["horizontal"]["mid_channel"]
    assert 0 < mid["avg_c"] < 1
    # sulcus_mid line only exists across the cavity -> fewer samples
    n_sulcus = prof["profiles"]["horizontal"]["sulcus_mid"]["n_samples"]
    n_mid = prof["profiles"]["horizontal"]["mid_channel"]["n_samples"]
    assert n_sulcus < n_mid


def test_boundary_flux_export(sulcus_solution, tmp_path):
    from fenics_eff_uptake.analysis.boundary_export import (
        export_boundary_flux_comparison)
    md, c = sulcus_solution
    out = export_boundary_flux_comparison(c, 1.0, 1.0, md, str(tmp_path))
    assert out is not None
    assert (tmp_path / "boundary_flux_comparison.csv").exists()
    assert (tmp_path / "flux_bottom.vtk").exists()
    # on the Robin boundary the facet-averaged physical and Robin fluxes
    # should broadly agree (same quantity, discretisation-level gap)
    import numpy as np
    rel = abs(out["physical"].sum() - out["robin"].sum()) / abs(
        out["robin"].sum())
    assert rel < 0.05


def test_batched_metrics_match_per_run(sulcus_solution):
    """The single-dispatch sweep metrics equal the per-run engine."""
    import jax.numpy as jnp
    from fenics_eff_uptake.analysis.batched_metrics import (
        build_sweep_metrics, metrics_to_dicts)
    md, c = sulcus_solution

    class P:
        L, H = 5.0, 1.0
        L_dim, H_dim = 5.0, 1.0
        sulci_h, sulci_w = 1.0, 0.5
        mu = 1.0
        mode = "no-adv"

    sm = build_sweep_metrics(c.space, md, D=1.0)
    X = jnp.stack([c.values, c.values * 0.5])
    flux_l, mass_l, mueff_l = metrics_to_dicts(
        sm, md, X, [1.0, 2.0], 1.0, [P, P])
    ref_fm = compute_flux_metrics(c, None, md, "sulcus", 1.0, 1.0,
                                  warn=False)
    ref_mm = compute_mass_metrics(c, md, "sulcus")
    ref_me = compute_mu_eff_metrics(c, md, P, ref_fm)
    fm, mm, me = flux_l[0], mass_l[0], mueff_l[0]
    for k in ("left", "right", "top", "bottom"):
        assert fm["physical_flux"][k]["total"] == pytest.approx(
            ref_fm["physical_flux"][k]["total"], rel=1e-10)
    assert fm["uptake_flux"] == pytest.approx(ref_fm["uptake_flux"],
                                              rel=1e-10)
    sf = fm["sulcus_specific"]["physical_flux"]
    rf = ref_fm["sulcus_specific"]["physical_flux"]
    for k in ("bottom_left", "sulcus", "bottom_right", "sulcus_opening",
              "y0_flux"):
        assert sf[k]["total"] == pytest.approx(rf[k]["total"], rel=1e-10)
    assert sf["sulcus_opening_extra"]["E_L1"] == pytest.approx(
        rf["sulcus_opening_extra"]["E_L1"], rel=1e-10)
    assert mm["total_mass"] == pytest.approx(ref_mm["total_mass"],
                                             rel=1e-12)
    assert mm["average_concentration"]["sulcus_region"] == pytest.approx(
        ref_mm["average_concentration"]["sulcus_region"], rel=1e-10)
    assert me["mu_eff_sim"] == pytest.approx(ref_me["mu_eff_sim"],
                                             rel=1e-9)
    assert me["mu_eff_open"] == pytest.approx(ref_me["mu_eff_open"],
                                              rel=1e-9)
    # second column scales linearly where expected (c halved)
    assert mass_l[1]["total_mass"] == pytest.approx(
        0.5 * mm["total_mass"], rel=1e-12)


def test_batched_metrics_advective_match_per_run(sulcus_solution):
    """Advective + per-sample D + step-mu batched metrics equal the
    per-run engine column by column."""
    import jax.numpy as jnp
    from fenics_eff_uptake.analysis.batched_metrics import (
        build_sweep_metrics, metrics_to_dicts)
    from fenics_eff_uptake.fem.space import FunctionSpace, Function
    md, c = sulcus_solution

    # analytic velocity shared across the batch (need not be physical:
    # the equivalence is a quadrature identity, not a PDE property)
    V = FunctionSpace(md, "P2", vs=2)
    xy = V.dof_coords
    uv = np.zeros(V.ndofs)
    uv[0::2] = xy[:, 1] * (1.0 - xy[:, 1]) + 0.1          # u_x(y)
    uv[1::2] = 0.05 * np.sin(xy[:, 0])                    # u_y(x)
    u = Function(V, jnp.asarray(uv))

    D_vals = [1.0, 0.4]
    mu_vals = [1.0, 3.0]

    def mu0(x):
        return np.where(np.abs(np.asarray(x) - 2.5) < 0.25, 2.0, 0.5)

    def mu1(x):
        return np.full_like(np.asarray(x, dtype=np.float64), 3.0)

    class P:
        L, H = 5.0, 1.0
        L_dim, H_dim = 5.0, 1.0
        sulci_h, sulci_w = 1.0, 0.5
        mu = 1.0
        mode = "adv-diff"

    sm = build_sweep_metrics(c.space, md, D=1.0, u=u,
                             mu_profiles=[mu0, mu1])
    X = jnp.stack([c.values, c.values * 0.5])
    flux_l, mass_l, _ = metrics_to_dicts(sm, md, X, mu_vals, 1.0,
                                         [P, P], D_values=D_vals)
    c1 = Function(c.space, c.values * 0.5)
    for b, (cb, Db, mub) in enumerate(
            zip([c, c1], D_vals, [mu0, mu1])):
        ref = compute_flux_metrics(cb, u, md, "sulcus", Db, mub,
                                   warn=False)
        fm = flux_l[b]
        for k in ("left", "right", "top", "bottom"):
            for f in ("diffusive", "advective", "total"):
                assert fm["physical_flux"][k][f] == pytest.approx(
                    ref["physical_flux"][k][f], rel=1e-10, abs=1e-13), (
                    b, k, f)
        assert fm["uptake_flux"] == pytest.approx(
            ref["uptake_flux"], rel=1e-10)
        sf = fm["sulcus_specific"]["physical_flux"]
        rf = ref["sulcus_specific"]["physical_flux"]
        for k in ("bottom_left", "sulcus", "bottom_right",
                  "sulcus_opening", "y0_flux"):
            for f in ("diffusive", "advective", "total"):
                assert sf[k][f] == pytest.approx(
                    rf[k][f], rel=1e-10, abs=1e-13), (b, k, f)
        for k in ("E_L1", "Q_in", "Q_out"):
            assert sf["sulcus_opening_extra"][k] == pytest.approx(
                rf["sulcus_opening_extra"][k], rel=1e-10)
        ru = ref["sulcus_specific"]["uptake_flux"]
        bu = fm["sulcus_specific"]["uptake_flux"]
        for k in ("bottom_left", "sulcus", "bottom_right", "total"):
            assert bu[k] == pytest.approx(ru[k], rel=1e-10, abs=1e-13), (
                b, k)
