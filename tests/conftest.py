"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Sharding tests use a virtual 8-device CPU mesh; numerical tests need f64.
The CPU is the default platform: JAX_PLATFORMS, when already set (e.g.
JAX_PLATFORMS=cuda for `pytest -m gpu` on a card), is left alone, and the
virtual devices are added only on the CPU.  Must run before jax
initialises its backend.
"""

import os

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# slow-test marking (VERDICT r3 item 8): the default `pytest tests/` runs
# the full ~19-minute pyramid; `pytest -m "not slow"` is the fast unit
# gate (~90 s) that still covers every module.  Measured-over-6s tests
# are listed here rather than decorated in place so the budget is
# maintained in one spot (re-derive with `pytest --durations=60`).
# ---------------------------------------------------------------------------

import pytest

_SLOW = {
    "test_batched_metrics_advective_match_per_run",
    "test_linear_solution_fluxes",
    "test_mass_metrics_rectangle",
    "test_sulcus_flux_identities",
    "test_band_matches_dense_scipy",
    "test_step_mu_robin_matrices",
    "test_stokes_banded_equivalence",
    "test_sweep_equivalence_advective",
    "test_sweep_equivalence_jacobi",
    "test_sweep_equivalence_multilevel",
    "test_sweep_equivalence_tband",
    "test_ns_inverse_matches_lapack_scalar_mu",
    "test_cg_vs_scipy_direct_with_robin",
    "test_mms_convergence",
    "test_operator_matches_scipy",
    "test_vtk_writers",
    "test_mixed_precision_matches_f64",
    "test_production_sharded_solve_matches_vmapped",
    "test_sharded_bicgstab_advective_matches_vmapped",
    "test_sharded_sweep_matches_vmapped",
    "test_vmapped_sweep_matches_single",
    "test_mu_eff_sim_vs_golden_moderate_mesh",
    "test_phase_b_cr_vs_golden_moderate_mesh",
    "test_comparison_and_summary",
    "test_phase_b_heatmaps",
    "test_plot_single_simulation",
    "test_self_golden_noadv",
    "test_advdiff_high_pe_gmres_matches_bicgstab",
    "test_run_simulation_advdiff_rect",
    "test_stokes_field_checkpoint_roundtrip",
    "test_stokes_mg_matches_schur",
    "test_stokes_pressure_pin_inconsequential",
    "test_multilevel_nested_level_cuts_iterations",
    "test_multilevel_preconditioner_matches_jacobi",
    "test_multilevel_with_shape_bucketing",
    "test_stokes_coarse_pressure_deflation",
    "test_advdiff_validation_subset",
    "test_mesh_convergence_ladder",
    "test_no_uptake_subset",
    "test_phase_a_mu_sweep_small",
    "test_phase_b_sharded_matches_unsharded",
    "test_no_uptake_sharded_matches_unsharded",
    "test_advdiff_sharded_matches_unsharded",
    "test_phase_b_subset",
}


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.  Tests
    that need the card take this fixture and carry the `gpu` marker."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW:
            item.add_marker(pytest.mark.slow)
