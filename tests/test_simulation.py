"""End-to-end orchestrator + Stokes + advdiff tests (coarse meshes).

Equivalent of the reference's __main__ smoke runs (simulation.py:351-382)
promoted to real assertions.
"""

import numpy as np
import pytest

from fenics_eff_uptake.meshing.generator import structured_rectangle
from fenics_eff_uptake.models.advdiff import advdiff_solve
from fenics_eff_uptake.models.stokes_flow import stokes_solve
from fenics_eff_uptake.params import Parameters
from fenics_eff_uptake.simulation import run_simulation


def _coarse_params(mode, **kw):
    p = Parameters(mode=mode, L_dim=5.0, H_dim=1.0,
                   sulci_w_dim=0.5, sulci_h_dim=0.5,
                   mesh_size_dim=0.15, **kw)
    p.validate()
    p.nondim()
    return p


def test_stokes_poiseuille_exact():
    md = structured_rectangle(2.0, 1.0, 10, 5)
    # exactness of the DISCRETISATION is what's under test, so ask the
    # solver for more than its study-default 1e-9 (which leaves ~5e-8
    # in the pressure -- fine for studies, above this test's floor)
    u, p = stokes_solve(md, H=1.0, outer_rtol=1e-12)
    assert u.solver_info["converged"]
    coords = u.space.dof_coords
    ux = u.as_numpy()[0::2]
    uy = u.as_numpy()[1::2]
    # Taylor-Hood contains the exact solution u=(4y(1-y),0), p=8(L-x)
    assert np.abs(ux - 4 * coords[:, 1] * (1 - coords[:, 1])).max() < 1e-9
    assert np.abs(uy).max() < 1e-9
    p_exact = 8 * (2.0 - p.space.dof_coords[:, 0])
    assert np.abs(p.as_numpy() - p_exact).max() < 1e-8


def test_advdiff_zero_velocity_matches_diffusion():
    from fenics_eff_uptake.models.diffusion import pure_diffusion_solve
    from fenics_eff_uptake.models.stokes_flow import stokes_zero_fields
    md = structured_rectangle(2.0, 1.0, 8, 4)
    u0, _ = stokes_zero_fields(md)
    c_ad = advdiff_solve(md, u0, D=0.5, mu=1.0)
    c_d = pure_diffusion_solve(md, D=0.5, mu=1.0)
    assert np.abs(c_ad.as_numpy() - c_d.as_numpy()).max() < 1e-9


def test_run_simulation_no_adv_sulcus(tmp_path):
    params = _coarse_params("no-adv")
    res = run_simulation("no-adv", "Test", "sulcus_test", "sulcus", params,
                         results_root=str(tmp_path), verbose=False)
    assert "mu_eff_comparison" in res
    me = res["mu_eff_comparison"]
    assert me["mu_eff_sim"] is not None
    mm = res["mass_metrics"]
    assert 0 < mm["average_concentration"]["total"] < 1
    # results JSON written
    f = (tmp_path / "No Advection Simulations" / "Test" / "sulcus_test"
         / "Results Data" / "simulation_results.json")
    assert f.exists()
    import json
    data = json.loads(f.read_text())
    assert "flux_metrics" in data and "mu_eff_comparison" in data


def test_run_simulation_advdiff_rect(tmp_path):
    params = _coarse_params("adv-diff", U_ref_dim=0.0003)  # Pe = 1
    assert params.Pe == pytest.approx(1.0)
    res = run_simulation("adv-diff", "Test", "rect_test", "rectangular",
                         params, results_root=str(tmp_path), verbose=False)
    assert "mu_eff_comparison" not in res
    # advective flux present at the inlet (c=1 there); at the outlet the
    # Dirichlet c=0 makes (u.n)c vanish identically
    pf = res["flux_metrics"]["physical_flux"]
    assert pf["left"]["advective"] != 0.0
    assert abs(pf["right"]["advective"]) < 1e-12
    # velocity metrics present for adv-diff mode
    assert res["vel_metrics"].get("global_max_umag", 0) > 0
    # global conservation: fluxes over the closed boundary sum to ~0
    # (left + right + top + bottom, bottom carrying the Robin uptake)
    total = sum(pf[k]["total"] for k in ("left", "right", "top", "bottom"))
    scale = max(abs(pf[k]["total"]) for k in ("left", "right", "bottom"))
    assert abs(total) < 0.05 * scale


def test_stokes_mg_matches_schur():
    """MINRES+MG Stokes == Uzawa/Schur Stokes on a sulcus mesh."""
    import numpy as np
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.models.stokes_flow import (
        stokes_solve_mg, stokes_solve_schur)
    mesh = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.3,
                         sulcus_width=0.3, mesh_size=0.15,
                         refinement_factor=1, domain_type="sulcus")
    u1, p1 = stokes_solve_mg(mesh, H=1.0, rtol=1e-11)
    u0, p0 = stokes_solve_schur(mesh, H=1.0)
    assert np.abs(np.asarray(u1.values) - np.asarray(u0.values)).max() \
        < 1e-8
    assert np.abs(np.asarray(p1.values) - np.asarray(p0.values)).max() \
        < 1e-6


def test_stokes_pressure_pin_inconsequential():
    """VERDICT round-1 item 8: the reference pins p at one outlet point
    (ref solvers.py:272-283) with legacy 'pointwise' semantics claimed to
    be a no-op.  Quantify: with the do-nothing outflow the unpinned
    pressure at the outlet corner is already ~0 (weak traction-free), so
    adding the pin perturbs p by only that discretization-level epsilon
    and u by far less -- parity is insensitive to whether the reference's
    pin matched a dof or not."""
    import numpy as np
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.models.stokes_flow import stokes_solve_mg
    mesh = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.3,
                         sulcus_width=0.3, mesh_size=0.15,
                         refinement_factor=1, domain_type="sulcus")
    u1, p1 = stokes_solve_mg(mesh, H=1.0, rtol=1e-11)
    u2, p2 = stokes_solve_mg(mesh, H=1.0, rtol=1e-11,
                             pin_outlet_pressure=True)
    p_scale = np.abs(np.asarray(p1.values)).max()
    dp = np.abs(np.asarray(p1.values) - np.asarray(p2.values)).max()
    du = np.abs(np.asarray(u1.values) - np.asarray(u2.values)).max()
    assert dp / p_scale < 1e-5, (dp, p_scale)
    assert du < 1e-5, du
    # the unpinned outlet-corner pressure is itself ~0: the level the pin
    # would enforce is already selected by the weak form
    pc = p1.space.dof_coords
    corner = int(np.argmin((pc[:, 0] - pc[:, 0].max()) ** 2
                           + pc[:, 1] ** 2))
    assert abs(float(np.asarray(p1.values)[corner])) / p_scale < 1e-5


def test_advdiff_high_pe_gmres_matches_bicgstab():
    """solver='auto' routes Pe>25 through restarted GMRES; same solution."""
    import numpy as np
    from fenics_eff_uptake.meshing.generator import structured_rectangle
    from fenics_eff_uptake.models.advdiff import advdiff_solve
    from fenics_eff_uptake.models.stokes_flow import stokes_solve
    md = structured_rectangle(2.0, 1.0, 16, 8)
    u, _ = stokes_solve(md, H=1.0)
    Pe = 40.0
    c_g = advdiff_solve(md, u, D=1.0 / Pe, mu=1.0, solver="auto")
    assert c_g.solver_info.get("method") == "gmres"
    c_b = advdiff_solve(md, u, D=1.0 / Pe, mu=1.0, solver=None)
    assert np.abs(c_g.as_numpy() - c_b.as_numpy()).max() < 1e-8


def test_stokes_field_checkpoint_roundtrip(tmp_path, monkeypatch):
    """stokes_solve disk-checkpoints the solved fields per geometry; a
    reload must be bit-identical to the solved fields."""
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path))
    md = structured_rectangle(2.0, 1.0, 8, 4)
    u1, p1 = stokes_solve(md, H=1.0)
    assert "+cache" not in u1.solver_info["method"]
    u2, p2 = stokes_solve(md, H=1.0)
    assert u2.solver_info["method"].endswith("+cache")
    assert np.array_equal(u1.as_numpy(), u2.as_numpy())
    assert np.array_equal(p1.as_numpy(), p2.as_numpy())
    assert u2.solver_info["outer_iters"] == u1.solver_info["outer_iters"]
