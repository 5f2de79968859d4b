"""Sweep batching (vmap) + device-mesh sharding (shard_map) tests.

Runs on the virtual 8-device CPU mesh from conftest.
"""

import jax
import numpy as np
import pytest

from fenics_eff_uptake.meshing.generator import structured_rectangle
from fenics_eff_uptake.models.diffusion import pure_diffusion_solve
from fenics_eff_uptake.parallel.sharding import (build_sharded_mu_sweep,
                                                     make_device_mesh)
from fenics_eff_uptake.parallel.sweep import (build_mu_sweep_system,
                                                  solve_mu_sweep)


@pytest.fixture(scope="module")
def mesh():
    return structured_rectangle(2.0, 1.0, 10, 5)


def test_vmapped_sweep_matches_single(mesh):
    sys = build_mu_sweep_system(mesh, D=1.0)
    mus = [0.1, 1.0, 10.0]
    X, info = solve_mu_sweep(sys, mus, rtol=1e-13)
    assert X.shape[0] == 3
    for i, mu in enumerate(mus):
        c = pure_diffusion_solve(mesh, D=1.0, mu=mu, element="P2")
        assert np.allclose(np.asarray(X[i]), c.as_numpy(), atol=1e-8), mu


def test_sharded_sweep_matches_vmapped(mesh):
    assert len(jax.devices()) >= 8, "conftest should give 8 CPU devices"
    dev_mesh = make_device_mesh(8, tp=2)   # 4-way sweep x 2-way cells
    sh = build_sharded_mu_sweep(mesh, dev_mesh, D=1.0, rtol=1e-12,
                                maxiter=5000)
    mus = [0.1, 0.5, 1.0, 2.0, 5.0]        # padded to 8 internally
    X = sh.solve(mus)
    assert X.shape[0] == 5
    sys = build_mu_sweep_system(mesh, D=1.0)
    Xref, _ = solve_mu_sweep(sys, mus, rtol=1e-13)
    assert np.allclose(np.asarray(X), np.asarray(Xref), atol=1e-7)


def test_mixed_precision_matches_f64(mesh):
    from fenics_eff_uptake.parallel.sweep import (build_transport_system,
                                                      solve_sweep)
    sys = build_transport_system(mesh)
    mus = [0.5, 2.0]
    X64, _ = solve_sweep(sys, [1.0, 1.0], mu_values=mus, precision="f64",
                         rtol=1e-13)
    Xmx, info = solve_sweep(sys, [1.0, 1.0], mu_values=mus,
                            precision="mixed", rtol=1e-12)
    assert np.abs(np.asarray(X64) - np.asarray(Xmx)).max() < 1e-9


def test_production_sharded_solve_matches_vmapped():
    """Chunked MG-preconditioned CG under shard_map == solve_sweep."""
    import numpy as np
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.parallel.sharded_solve import (
        build_sharded_system, sharded_solve_sweep)
    from fenics_eff_uptake.parallel.sharding import make_device_mesh
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake.solvers.multilevel import build_multilevel

    kw = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
    mesh = generate_mesh(mesh_size=0.15, **kw)
    mids = [generate_mesh(mesh_size=0.3, **kw),
            generate_mesh(mesh_size=0.6, **kw)]
    sys_t = build_transport_system(mesh, element="P2", pad_shapes=False)
    mus = np.array([0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0])
    D = np.ones_like(mus)
    ml = build_multilevel(sys_t, mids, D, mu_values=mus)

    dev_mesh = make_device_mesh(8, tp=2)   # 4-way sweep x 2-way cells
    ss = build_sharded_system(sys_t, dev_mesh, multilevel=ml)
    X_sh, info = sharded_solve_sweep(ss, D, mus, rtol=1e-11,
                                     chunk_iters=20, maxiter=2000)
    assert (info["rel_resnorm"] < 1e-10).all()

    X_ref, _ = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-12,
                           precision="f64", multilevel=ml,
                           chunk_iters=20, maxiter=2000)
    assert np.abs(np.asarray(X_sh) - np.asarray(X_ref)).max() < 1e-9


def test_sharded_bicgstab_advective_matches_vmapped():
    """Nonsymmetric (adv-diff) sweep under shard_map == solve_sweep.

    Exercises the sharded BiCGStab chunk (parallel/sharded_solve.py
    _bicgstab_chunk_sharded): DP over "sweep" x element-partitioned
    operator with psum("cells"), Poiseuille advection, Jacobi M.
    """
    import jax.numpy as jnp
    from fenics_eff_uptake.fem.space import FunctionSpace
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.parallel.sharded_solve import (
        build_sharded_system, sharded_solve_sweep)
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, solve_sweep)

    kw = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
    m = generate_mesh(mesh_size=0.15, **kw)
    V = FunctionSpace(m, "P2", vs=2)
    xy = V.dof_coords
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    sys_t = build_transport_system(m, element="P2", pad_shapes=False,
                                   u_values=jnp.asarray(u), u_space=V)
    assert sys_t.Adv is not None
    mus = np.array([0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0])
    D = np.full_like(mus, 0.25)

    dev_mesh = make_device_mesh(8, tp=2)   # 4-way sweep x 2-way cells
    ss = build_sharded_system(sys_t, dev_mesh)
    X_sh, info = sharded_solve_sweep(ss, D, mus, rtol=1e-11,
                                     chunk_iters=40, maxiter=4000)
    assert (info["rel_resnorm"] < 1e-10).all()

    X_ref, _ = solve_sweep(sys_t, D, mu_values=mus, rtol=1e-12,
                           precision="f64", chunk_iters=40, maxiter=4000)
    assert np.abs(np.asarray(X_sh) - np.asarray(X_ref)).max() < 1e-8


@pytest.mark.slow  # ~43 s: the single heaviest fast-gate test; the
# sharded Stokes path is also exercised every round by the driver's
# dryrun_multichip and by the two (faster) sharded transport tests above
def test_sharded_stokes_matches_single_chip():
    """Saddle MINRES under shard_map == stokes_solve_mg (f64).

    Exercises the sharded Stokes path (parallel/sharded_solve.py
    build_sharded_stokes / sharded_stokes_solve): velocity stiffness +
    divergence coupling element-partitioned over "cells" with one fused
    psum per saddle apply, replicated V-cycle mid/coarse levels and
    Schur deflation.  Analogue of the reference's latent MPI Stokes
    capability (ref solvers.py:291-298).
    """
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.models.stokes_flow import stokes_solve_mg
    from fenics_eff_uptake.parallel.sharded_solve import (
        build_sharded_stokes, sharded_stokes_solve)
    from fenics_eff_uptake.parallel.sharding import make_device_mesh

    mesh = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.25,
                         sulcus_width=0.25, mesh_size=0.15,
                         refinement_factor=1, domain_type="sulcus")
    dev_mesh = make_device_mesh(8, tp=4)   # 2-way sweep x 4-way cells
    sst = build_sharded_stokes(mesh, H=1.0, device_mesh=dev_mesh)
    u_sh, p_sh, info = sharded_stokes_solve(sst, rtol=1e-10,
                                            chunk_iters=40)
    assert info["converged"], info
    assert info["rel_resnorm"] < 1e-8

    u0, p0 = stokes_solve_mg(mesh, H=1.0, precision="f64", rtol=1e-10)
    du = np.abs(np.asarray(u_sh.values) - np.asarray(u0.values)).max()
    dp = np.abs(np.asarray(p_sh.values) - np.asarray(p0.values)).max()
    un = np.abs(np.asarray(u0.values)).max()
    pn = np.abs(np.asarray(p0.values)).max()
    assert du / un < 1e-7, du / un
    assert dp / pn < 1e-7, dp / pn


def test_sharded_step_mu_robin_matches_vmapped():
    """Per-sample step-mu(x) Robin batches under shard_map == solve_sweep.

    Exercises the sharded per-sample Robin path (parallel/
    sharded_solve.py build_sharded_system(robin_batch=...) +
    _local_apply A_batch): the rectangular step-mu surrogates of the
    flagship adv-diff validation (ref adv_diff_analysis.py:144-178)
    with Poiseuille advection -> the sharded BiCGStab chunk with
    cells-partitioned per-sample Robin entity matrices.
    """
    import jax.numpy as jnp
    from fenics_eff_uptake.fem.space import FunctionSpace
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.params import StepUptakeOpen
    from fenics_eff_uptake.parallel.sharded_solve import (
        build_sharded_system, sharded_solve_sweep)
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, robin_matrices_for_mu, solve_sweep)

    m = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.0,
                      sulcus_width=0.0, mesh_size=0.15,
                      refinement_factor=1, domain_type="rectangular")
    V = FunctionSpace(m, "P2", vs=2)
    xy = V.dof_coords
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    sys_t = build_transport_system(m, element="P2", pad_shapes=False,
                                   u_values=jnp.asarray(u), u_space=V)
    assert sys_t.Adv is not None and sys_t.R is not None

    steps = [StepUptakeOpen(mu_base=mb, mu_eff_target=mt,
                            sulcus_left_x=2.25, sulcus_right_x=2.75,
                            L_c=0.05, Gamma=5.0)
             for (mb, mt) in [(0.1, 1.7), (1.0, 0.6), (10.0, 3.0),
                              (0.5, 0.5)]]
    R_batch = np.stack([np.asarray(robin_matrices_for_mu(sys_t, s))
                        for s in steps])
    D = np.array([10.0, 1.0, 0.1, 1.0])

    dev_mesh = make_device_mesh(8, tp=2)   # 4-way sweep x 2-way cells
    ss = build_sharded_system(sys_t, dev_mesh, robin_batch=R_batch)
    X_sh, info = sharded_solve_sweep(ss, D, np.zeros_like(D), rtol=1e-11,
                                     chunk_iters=40, maxiter=4000)
    assert (info["rel_resnorm"] < 1e-10).all()

    X_ref, _ = solve_sweep(sys_t, D, robin_matrices=jnp.asarray(R_batch),
                           rtol=1e-12, precision="f64", chunk_iters=40,
                           maxiter=4000)
    scale = np.abs(np.asarray(X_ref)).max()
    assert np.abs(np.asarray(X_sh) - np.asarray(X_ref)).max() / scale \
        < 1e-8


def test_sharded_step_mu_robin_with_mg_matches_vmapped():
    """Same as above but through the MG-preconditioned sharded chunk:
    fine-level per-sample Robin rides the cells-sharded apply (Rbb) and
    the replicated mid-level sub-cycle consumes la.R_batch."""
    import jax.numpy as jnp
    from fenics_eff_uptake.fem.space import FunctionSpace
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.params import StepUptakeOpen
    from fenics_eff_uptake.parallel.sharded_solve import (
        build_sharded_system, sharded_solve_sweep)
    from fenics_eff_uptake.parallel.sweep import (
        build_transport_system, robin_matrices_for_mu, solve_sweep)
    from fenics_eff_uptake.solvers.multilevel import \
        build_multilevel_for

    kw = dict(width=5.0, height=1.0, sulcus_depth=0.0, sulcus_width=0.0,
              refinement_factor=1, domain_type="rectangular")
    m = generate_mesh(mesh_size=0.15, **kw)
    V = FunctionSpace(m, "P2", vs=2)
    xy = V.dof_coords
    uv = np.zeros(V.ndofs)
    uv[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    from fenics_eff_uptake.fem.space import Function
    u = Function(V, jnp.asarray(uv))
    sys_t = build_transport_system(m, element="P2", pad_shapes=False,
                                   u_values=u.values, u_space=V)

    steps = [StepUptakeOpen(mu_base=mb, mu_eff_target=mt,
                            sulcus_left_x=2.25, sulcus_right_x=2.75,
                            L_c=0.05, Gamma=5.0)
             for (mb, mt) in [(0.1, 1.7), (1.0, 0.6), (10.0, 3.0),
                              (0.5, 0.5)]]
    R_batch = np.stack([np.asarray(robin_matrices_for_mu(sys_t, s))
                        for s in steps])
    D = np.array([10.0, 1.0, 0.1, 1.0])

    ml = build_multilevel_for(sys_t, m, D, mu_callables=steps,
                              robin_matrices_fine=jnp.asarray(R_batch),
                              u_fine=u)
    dev_mesh = make_device_mesh(8, tp=2)
    ss = build_sharded_system(sys_t, dev_mesh, multilevel=ml,
                              robin_batch=R_batch)
    X_sh, info = sharded_solve_sweep(ss, D, np.zeros_like(D), rtol=1e-11,
                                     chunk_iters=20, maxiter=4000)
    assert (info["rel_resnorm"] < 1e-10).all()

    X_ref, _ = solve_sweep(sys_t, D, robin_matrices=jnp.asarray(R_batch),
                           rtol=1e-12, precision="f64", chunk_iters=40,
                           maxiter=4000)
    scale = np.abs(np.asarray(X_ref)).max()
    assert np.abs(np.asarray(X_sh) - np.asarray(X_ref)).max() / scale \
        < 1e-8
