"""Krylov solver unit tests (CG / BiCGStab / GMRES / batched engine)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp


def _spd(n, seed=0):
    rng = np.random.RandomState(seed)
    A = sp.random(n, n, density=0.05, random_state=rng)
    A = (A + A.T).toarray() + n * np.eye(n)
    return A


def _nonsym(n, seed=0):
    A = _spd(n, seed)
    rng = np.random.RandomState(seed + 1)
    A = A + 0.5 * rng.randn(n, n) / np.sqrt(n)
    return A


def test_gmres_vs_direct():
    from fenics_eff_uptake.solvers.gmres import gmres
    n = 120
    A = _nonsym(n)
    b = np.random.RandomState(2).randn(n)
    Aj = jnp.asarray(A)
    res = gmres(lambda x: Aj @ x, jnp.asarray(b), rtol=1e-12, restart=30)
    assert res.converged, res.resnorm
    x_direct = np.linalg.solve(A, b)
    assert np.abs(np.asarray(res.x) - x_direct).max() < 1e-8


def test_gmres_with_preconditioner():
    from fenics_eff_uptake.solvers.gmres import gmres
    n = 150
    A = _nonsym(n, seed=5)
    b = np.ones(n)
    Aj = jnp.asarray(A)
    dinv = jnp.asarray(1.0 / np.diag(A))
    res = gmres(lambda x: Aj @ x, jnp.asarray(b),
                M=lambda r: dinv * r, rtol=1e-11, restart=25)
    assert res.converged
    assert np.abs(np.asarray(res.x) - np.linalg.solve(A, b)).max() < 1e-7


def test_batched_bicgstab_vs_direct():
    from fenics_eff_uptake.solvers.batched import batched_bicgstab
    n, B = 100, 3
    A = _nonsym(n, seed=7)
    Aj = jnp.asarray(A)
    rhs = np.random.RandomState(3).randn(n, B)
    res = batched_bicgstab(lambda X: Aj @ X, jnp.asarray(rhs),
                           rtol=1e-12, maxiter=2000, chunk_iters=25)
    X_direct = np.linalg.solve(A, rhs)
    assert np.abs(np.asarray(res.X) - X_direct).max() < 1e-7


def test_batched_cg_partial_convergence_freeze():
    """Columns with very different conditioning converge independently."""
    from fenics_eff_uptake.solvers.batched import batched_cg
    n = 80
    A1 = _spd(n, seed=1)
    Aj = jnp.asarray(A1)
    rhs = np.random.RandomState(4).randn(n, 2)
    rhs[:, 1] *= 1e6   # huge-scale column
    res = batched_cg(lambda X: Aj @ X, jnp.asarray(rhs),
                     rtol=1e-12, maxiter=2000, chunk_iters=20)
    X_direct = np.linalg.solve(A1, rhs)
    rel = np.abs(np.asarray(res.X) - X_direct).max(axis=0) / \
        np.abs(X_direct).max(axis=0)
    assert (rel < 1e-8).all()


def test_multilevel_preconditioner_matches_jacobi():
    """MG-preconditioned sweep == Jacobi-CG sweep, with far fewer iters."""
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake.solvers.multilevel import build_multilevel

    kw = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
    mesh = generate_mesh(mesh_size=0.15, **kw)
    mids = [generate_mesh(mesh_size=0.3, **kw),
            generate_mesh(mesh_size=0.6, **kw)]
    sys_t = build_transport_system(mesh, element="P2", pad_shapes=False)
    mus = np.array([0.1, 1.0, 10.0])
    D = np.ones_like(mus)
    ml = build_multilevel(sys_t, mids, D, mu_values=mus)
    X_ml, info_ml = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-12,
                                precision="f64", multilevel=ml,
                                chunk_iters=10, maxiter=1000)
    X_j, info_j = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-12,
                              precision="f64", chunk_iters=100,
                              maxiter=20000)
    assert np.abs(np.asarray(X_ml) - np.asarray(X_j)).max() < 1e-8
    assert info_ml["iters"].max() < info_j["iters"].max() / 3
    # mixed precision through the same preconditioner
    X_m, _ = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-11,
                         precision="mixed", multilevel=ml,
                         chunk_iters=10, maxiter=1000)
    assert np.abs(np.asarray(X_m) - np.asarray(X_j)).max() < 1e-7


def test_multilevel_with_shape_bucketing():
    """Padded fine + padded MG levels (the shape-bucketed study configuration):
    same solution as the unpadded path."""
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake.solvers.multilevel import build_multilevel

    kw = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
    mesh = generate_mesh(mesh_size=0.15, **kw)
    mids = [generate_mesh(mesh_size=0.3, **kw),
            generate_mesh(mesh_size=0.6, **kw)]
    mus = np.array([0.5, 5.0])
    D = np.ones_like(mus)

    sys_p = build_transport_system(mesh, element="P2", pad_shapes=True)
    ml_p = build_multilevel(sys_p, mids, D, mu_values=mus)
    # levels are bucketed: padded beyond true size, at the size-tiered
    # granularity (>=512) so study geometries share compiled shapes
    lv1 = ml_p.levels[1].sys
    assert lv1.ndofs % 512 == 0
    assert lv1.ndofs > lv1.space.ndofs
    X_p, info = solve_sweep(sys_p, D, mu_values=mus, rtol=1e-12,
                            precision="mixed", multilevel=ml_p,
                            chunk_iters=10, maxiter=1000)

    sys_u = build_transport_system(mesh, element="P2", pad_shapes=False)
    X_u, _ = solve_sweep(sys_u, D, mu_values=mus, rtol=1e-13,
                         precision="f64", chunk_iters=100, maxiter=20000)
    assert np.abs(np.asarray(X_p) - np.asarray(X_u)).max() < 1e-8


def test_multilevel_nested_level_cuts_iterations():
    """The nested P1-on-the-fine-mesh first level (exact embedding,
    level_meshes_for default) must converge in substantially fewer CG
    iterations than the non-nested P2 -> P1(2h) -> P1(4h) ladder, with
    the same solution."""
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake.solvers.multilevel import build_multilevel

    kw = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
    mesh = generate_mesh(mesh_size=0.08, **kw)
    coarser = [generate_mesh(mesh_size=0.24, **kw),
               generate_mesh(mesh_size=0.48, **kw)]
    sys_t = build_transport_system(mesh, element="P2", pad_shapes=False)
    mus = np.array([0.1, 10.0])
    D = np.ones_like(mus)

    ml_flat = build_multilevel(sys_t, coarser, D, mu_values=mus)
    X_f, info_f = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-11,
                              precision="mixed", multilevel=ml_flat,
                              chunk_iters=10, maxiter=1000)
    ml_nest = build_multilevel(sys_t, [mesh] + coarser, D, mu_values=mus)
    X_n, info_n = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-11,
                              precision="mixed", multilevel=ml_nest,
                              chunk_iters=10, maxiter=1000)
    assert np.abs(np.asarray(X_n) - np.asarray(X_f)).max() < 1e-8
    assert info_n["iters"].max() <= info_f["iters"].max() * 0.6


def test_level_meshes_for_nested_default(monkeypatch):
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.solvers.multilevel import level_meshes_for
    m = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.25,
                      sulcus_width=0.25, mesh_size=0.1,
                      refinement_factor=1, domain_type="sulcus")
    lv = level_meshes_for(m)
    assert lv[0] is m and len(lv) == 3
    monkeypatch.setenv("FEU_ML_NESTED", "0")
    lv0 = level_meshes_for(m)
    assert lv0[0] is not m and len(lv0) == 2


def test_stokes_coarse_pressure_deflation(monkeypatch):
    """The coarse Schur correction (cosine-in-x + cavity-ladder + corner
    bumps deflation; models/stokes_flow._coarse_pressure_basis) must cut
    the MINRES iteration count substantially on an elongated channel --
    the inf-sup tail scales as 1/AR^2 and cost ~420-600 iterations in
    round 2 -- while producing the same flow field.

    Replaces nothing in the reference (its solvers.py:291-298 is a
    direct LU); this pins the iterative path's iteration economy.
    """
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.models.stokes_flow import stokes_solve_mg

    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=0.25,
                         sulcus_width=0.25, mesh_size=0.12,
                         refinement_factor=1, domain_type="sulcus")
    monkeypatch.setenv("FEU_STOKES_COARSE_P", "0")
    u0, p0 = stokes_solve_mg(mesh, H=1.0, precision="f64")
    monkeypatch.setenv("FEU_STOKES_COARSE_P", "1")
    u1, p1 = stokes_solve_mg(mesh, H=1.0, precision="f64")

    it0 = u0.solver_info["outer_iters"]
    it1 = u1.solver_info["outer_iters"]
    assert u1.solver_info["converged"]
    assert it1 <= 0.75 * it0, (it0, it1)
    du = np.abs(u1.as_numpy() - u0.as_numpy()).max()
    scale = np.abs(u0.as_numpy()).max()
    assert du <= 1e-7 * scale, (du, scale)

def test_twolevel_fallback_preconditioner():
    """solvers/twolevel.py stays live: passing coarse_mesh (no multilevel)
    to solve_sweep builds the two-level preconditioner fallback and
    converges to the Jacobi answer with fewer iterations."""
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, solve_sweep)

    kw = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
    mesh = generate_mesh(mesh_size=0.15, **kw)
    coarse = generate_mesh(mesh_size=0.45, **kw)
    sys_t = build_transport_system(mesh, element="P2", pad_shapes=False)
    mus = np.array([0.1, 1.0, 10.0])
    D = np.ones_like(mus)
    X_tl, info_tl = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-12,
                                precision="f64", coarse_mesh=coarse,
                                chunk_iters=20, maxiter=4000)
    X_j, info_j = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-12,
                              precision="f64", chunk_iters=100,
                              maxiter=20000)
    assert np.abs(np.asarray(X_tl) - np.asarray(X_j)).max() < 1e-8
    assert info_tl["iters"].max() < info_j["iters"].max()
