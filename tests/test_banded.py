"""Banded-dense operator form vs the element gather/scatter path.

The band (ops/banded.py) is the optional f32 inner-Krylov operator form; these
tests pin (a) the RCM permutation round-trip, (b) apply equivalence at
f32 roundoff, (c) full mixed-precision sweep equivalence with plain
Jacobi AND with the multigrid V-cycle (banded fine+mid levels, permuted
transfers), and (d) the advective (nonsymmetric) path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fenics_eff_uptake.meshing.generator import generate_mesh
from fenics_eff_uptake.ops.banded import (band_apply,
                                              band_from_elements,
                                              build_band_plan,
                                              rcm_permutation)
from fenics_eff_uptake.parallel.sweep import (_operator_program,
                                                  build_transport_system,
                                                  operator_args,
                                                  solve_sweep,
                                                  sys_struct_key)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(mesh_size=0.08, **KW)


@pytest.fixture(scope="module")
def systems(mesh):
    ref = build_transport_system(mesh, element="P2", pad_shapes=True,
                                 band=False)
    bnd = build_transport_system(mesh, element="P2", pad_shapes=True,
                                 band=True)
    return ref, bnd


def test_rcm_permutation_roundtrip(systems):
    _, bnd = systems
    assert bnd.perm is not None and bnd.iperm is not None
    n = bnd.ndofs
    assert np.array_equal(np.sort(bnd.perm), np.arange(n))
    assert np.array_equal(bnd.perm[bnd.iperm], np.arange(n))
    # padding dofs keep tail positions
    n_true = bnd.space.ndofs
    assert np.array_equal(bnd.perm[n_true:], np.arange(n_true, n))
    # permuted free/bc agree with the unpermuted system's
    ref, _ = systems
    assert np.array_equal(np.asarray(ref.free)[bnd.perm],
                          np.asarray(bnd.free))
    np.testing.assert_array_equal(np.asarray(ref.bc_values)[bnd.perm],
                                  np.asarray(bnd.bc_values))


def test_band_matches_dense_scipy(systems):
    _, bnd = systems
    # reconstruct dense from the band and compare against the element COO
    T, R, W = bnd.Kband.shape
    halo = (W // R - 1) // 2
    n = bnd.ndofs
    dense = np.zeros((n, n))
    band = np.asarray(bnd.Kband, dtype=np.float64)
    for t in range(T):
        lo = (t - halo) * R
        for w in range(W):
            c = lo + w
            if 0 <= c < n:
                dense[t * R:(t + 1) * R, c] = band[t, :, w]
    import scipy.sparse as sps
    dofs = np.asarray(bnd.K.dofs, dtype=np.int64)
    Ae = np.asarray(bnd.K.A32, dtype=np.float64)
    nd = dofs.shape[1]
    rows = np.repeat(dofs, nd, axis=1).ravel()
    cols = np.tile(dofs, (1, nd)).ravel()
    coo = sps.coo_matrix((Ae.reshape(-1), (rows, cols)),
                         shape=(n, n)).toarray()
    np.testing.assert_allclose(dense, coo, atol=1e-6)


def test_apply_equivalence(systems):
    _, bnd = systems
    B = 4
    mus = jnp.asarray([0.1, 0.5, 1.0, 2.0])
    D = jnp.ones(B)
    A_fn = _operator_program(sys_struct_key(bnd))[0]
    a32 = operator_args(bnd, D, mus, None, f32=True)
    a32_nb = (a32[0]._replace(band=None),) + a32[1:]
    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.randn(bnd.ndofs, B).astype(np.float32))
    Y1, Y2 = A_fn(a32, X), A_fn(a32_nb, X)
    rel = float(jnp.abs(Y1 - Y2).max() / jnp.abs(Y2).max())
    assert rel < 2e-5


def test_sweep_equivalence_jacobi(systems):
    ref, bnd = systems
    mus = np.array([0.1, 0.5, 1.0, 2.0])
    D = np.ones(4)
    X1, _ = solve_sweep(bnd, D, mu_values=mus, rtol=1e-11,
                        precision="mixed")
    X2, _ = solve_sweep(ref, D, mu_values=mus, rtol=1e-11,
                        precision="mixed")
    assert float(jnp.abs(X1 - X2).max()) < 1e-8


def test_sweep_equivalence_multilevel(mesh, systems):
    ref, bnd = systems
    from fenics_eff_uptake.solvers.multilevel import build_multilevel
    mids = [generate_mesh(mesh_size=0.24, **KW),
            generate_mesh(mesh_size=0.45, **KW)]
    mus = np.array([0.1, 1.0, 10.0])
    D = np.ones(3)
    ml_b = build_multilevel(bnd, mids, D, mu_values=mus)
    ml_r = build_multilevel(ref, mids, D, mu_values=mus)
    X1, i1 = solve_sweep(bnd, D, mu_values=mus, rtol=1e-11,
                         precision="mixed", multilevel=ml_b,
                         chunk_iters=25)
    X2, i2 = solve_sweep(ref, D, mu_values=mus, rtol=1e-11,
                         precision="mixed", multilevel=ml_r,
                         chunk_iters=25)
    assert float(jnp.abs(X1 - X2).max()) < 1e-8
    assert (np.asarray(i1["rel_resnorm"]) < 1e-10).all()


def test_sweep_equivalence_advective(mesh):
    # nonsymmetric path: Advband + BiCGStab refinement
    from fenics_eff_uptake.fem.space import FunctionSpace
    V = FunctionSpace(mesh, "P2", vs=2)
    xy = V.dof_coords
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    ref = build_transport_system(mesh, u_values=jnp.asarray(u), u_space=V,
                                 pad_shapes=True, band=False)
    bnd = build_transport_system(mesh, u_values=jnp.asarray(u), u_space=V,
                                 pad_shapes=True, band=True)
    assert bnd.Advband is not None
    mus = np.array([0.5, 1.0])
    D = np.full(2, 0.2)
    X1, _ = solve_sweep(bnd, D, mu_values=mus, rtol=1e-10,
                        precision="mixed")
    X2, _ = solve_sweep(ref, D, mu_values=mus, rtol=1e-10,
                        precision="mixed")
    assert float(jnp.abs(X1 - X2).max()) < 1e-7


def test_step_mu_robin_matrices(mesh):
    # per-sample Robin matrices stay on the element path; solutions in
    # space numbering must match between banded and element systems
    from fenics_eff_uptake.parallel.sweep import robin_matrices_for_mu
    ref = build_transport_system(mesh, pad_shapes=True, band=False)
    bnd = build_transport_system(mesh, pad_shapes=True, band=True)

    def mu_fn(x):
        # called with the x-coordinate array (F, Q)
        return 1.0 + 0.5 * np.tanh((np.asarray(x) - 5.0) / 0.3)

    Rb = np.stack([np.asarray(robin_matrices_for_mu(ref, mu_fn))] * 2)
    Rb2 = np.stack([np.asarray(robin_matrices_for_mu(bnd, mu_fn))] * 2)
    # facet-aligned element matrices are numbering-independent
    np.testing.assert_allclose(Rb, Rb2, rtol=0, atol=0)
    D = np.ones(2)
    X1, _ = solve_sweep(bnd, D, robin_matrices=Rb, rtol=1e-11,
                        precision="mixed")
    X2, _ = solve_sweep(ref, D, robin_matrices=Rb, rtol=1e-11,
                        precision="mixed")
    assert float(jnp.abs(X1 - X2).max()) < 1e-8


def test_stokes_banded_equivalence(mesh):
    # banded (RCM-renumbered) velocity block in the MINRES saddle solve:
    # G lift / divergence columns / extraction mapped through iperm
    from fenics_eff_uptake.models.stokes_flow import stokes_solve_mg
    u1, p1 = stokes_solve_mg(mesh, 1.0, pad_shapes=True)
    u2, p2 = stokes_solve_mg(mesh, 1.0, pad_shapes=False)
    du = float(jnp.abs(u1.values - u2.values).max())
    dp = float(jnp.abs(p1.values - p2.values).max())
    assert du < 1e-8 and dp < 1e-7, (du, dp)


def test_band_apply_unit():
    # tiny hand-checked case: 1 tile, halo 1
    plan = build_band_plan(np.array([[0, 1], [1, 2]]), 256, tile=256)
    Ae = jnp.asarray(np.array([[[1.0, 2.0], [3.0, 4.0]],
                               [[5.0, 6.0], [7.0, 8.0]]]))
    band = band_from_elements(Ae, plan)
    X = jnp.zeros((256, 2), jnp.float32)
    X = X.at[0, 0].set(1.0).at[1, 0].set(1.0).at[2, 1].set(2.0)
    Y = band_apply(band, X)
    # A = [[1,2,0],[3,4+5,6],[0,7,8]] on dofs 0..2
    np.testing.assert_allclose(np.asarray(Y[:3, 0]), [3.0, 12.0, 7.0],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(Y[:3, 1]), [0.0, 12.0, 16.0],
                               rtol=1e-6)


def test_diskcache_roundtrip(tmp_path, monkeypatch):
    from fenics_eff_uptake.utils import diskcache as dc
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path))
    key = dc.cache_key_of(np.arange(5), "tag", None, 3.5)
    calls = []

    def build():
        calls.append(1)
        return {"a": np.eye(3), "n": 7}

    out1, hit1 = dc.cached_arrays("t", key, build)
    out2, hit2 = dc.cached_arrays("t", key, build)
    assert not hit1 and hit2 and len(calls) == 1
    np.testing.assert_array_equal(out2["a"], np.eye(3))
    assert out2["n"] == 7
    # disabled cache -> always a miss, no files
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    _, hit3 = dc.cached_arrays("t", key, build)
    assert not hit3 and len(calls) == 2


def test_band_plan_halo_quantized():
    """Halos snap to the fixed menu so band widths (compile-relevant
    shapes) are shared across geometry classes in multi-mesh studies."""
    from fenics_eff_uptake.ops.banded import build_band_plan
    # spread 700 would be halo 6 unquantized -> power-of-two menu 8
    # (the menu is deliberately sparse: h=0.02 study meshes straddled
    # adjacent halos and recompiled the full solver stack per class)
    dofs = np.array([[0, 700]])
    plan = build_band_plan(dofs, 1024, tile=128)
    assert plan.halo == 8
    assert plan.width == (2 * 8 + 1) * 128
    # spread within halo 1 stays 1
    plan = build_band_plan(np.array([[0, 100]]), 1024, tile=128)
    assert plan.halo == 1


def test_best_bandwidth_permutation_prefers_geometric():
    """On an elongated strip the lexicographic sweep must beat RCM (or
    tie); the returned permutation must be a valid bijection."""
    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.fem.space import FunctionSpace
    from fenics_eff_uptake.ops.banded import (
        best_bandwidth_permutation, rcm_permutation, _spread_of)
    m = generate_mesh(width=10.0, height=1.0, sulcus_depth=0.25,
                      sulcus_width=0.25, mesh_size=0.1,
                      refinement_factor=1, domain_type="sulcus")
    sp = FunctionSpace(m, "P2")
    ed = np.asarray(sp.cell_dofs)
    n = sp.ndofs
    n2o, o2n = best_bandwidth_permutation(ed, np.asarray(sp.dof_coords),
                                          n, n)
    assert np.array_equal(np.sort(n2o), np.arange(n))
    assert np.array_equal(o2n[n2o], np.arange(n))
    _, o2n_rcm = rcm_permutation(ed, n, n)
    assert _spread_of(ed, o2n) <= _spread_of(ed, o2n_rcm)


def _random_transfer(rng, nf, nc):
    """Transfer-shaped sparse triples with geometric locality: fine row
    i's coarse cols cluster near i * nc / nf (what the lexicographic
    dof orderings give on real meshes)."""
    base = (np.arange(nf) * nc) // nf
    jitter = rng.integers(-3, 4, size=(nf, 3))
    cols = np.clip(base[:, None] + jitter, 0, nc - 1)
    w = rng.random((nf, 3)).astype(np.float32)
    w[rng.random(nf) < 0.1] = 0.0          # padded/constrained rows
    return cols, w


def test_rect_band_matches_gather_segment_paths():
    """Windowed-band restrict/prolong must reproduce the gather+einsum
    and segment-sum formulations (the V-cycle's reference semantics)."""
    import jax
    import jax.numpy as jnp
    from fenics_eff_uptake.ops.banded import (
        build_rect_band_plan, rect_band_values, rect_band_apply_ref)

    rng = np.random.default_rng(7)
    nf, nc, B = 1024, 273, 5
    cols, w = _random_transfer(rng, nf, nc)
    rows = np.repeat(np.arange(nf), 3)

    # prolong direction: (nf x nc) @ (nc, B)
    p = build_rect_band_plan(rows, cols.ravel(), w.ravel(), nf, nc,
                             tile=256)
    assert p is not None
    band = rect_band_values(p, jnp.asarray(w))
    Xc = jnp.asarray(rng.random((nc, B)), jnp.float32)
    Xq = jnp.pad(Xc, ((0, p.n_cols_pad - nc), (0, 0)))
    want = np.einsum("nk,nkb->nb", w, np.asarray(Xc)[cols])
    got_ref = rect_band_apply_ref(band, jnp.asarray(p.offs), Xq)[:nf]
    np.testing.assert_allclose(np.asarray(got_ref), want, atol=2e-5)

    # restrict direction: transpose, output sliced to nc
    r = build_rect_band_plan(cols.ravel(), rows, w.ravel(), nc, nf,
                             tile=256)
    assert r is not None
    band_r = rect_band_values(r, jnp.asarray(w))
    Xf = jnp.asarray(rng.random((nf, B)), jnp.float32)
    Xfq = jnp.pad(Xf, ((0, r.n_cols_pad - nf), (0, 0)))
    contrib = (w[:, :, None] * np.asarray(Xf)[:, None, :]).reshape(-1, B)
    want_r = np.zeros((nc, B), np.float32)
    np.add.at(want_r, cols.ravel(), contrib)
    got_r = rect_band_apply_ref(band_r, jnp.asarray(r.offs), Xfq)[:nc]
    np.testing.assert_allclose(np.asarray(got_r), want_r, atol=2e-4)


def test_rect_band_plan_rejects_nonlocal():
    """A transfer with no index locality must fall back (None) rather
    than build a monster band."""
    from fenics_eff_uptake.ops.banded import build_rect_band_plan
    rng = np.random.default_rng(3)
    nf, nc = 1 << 15, 1 << 14
    rows = np.repeat(np.arange(nf), 3)
    cols = rng.integers(0, nc, size=3 * nf)       # random: zero locality
    vals = np.ones(3 * nf, np.float32)
    assert build_rect_band_plan(rows, cols, vals, nf, nc,
                                max_bytes=8 << 20) is None


def test_sweep_equivalence_tband(mesh, systems, monkeypatch):
    """Full ML solve with windowed-band transfers (FEU_ML_TBAND=1)
    must match the gather-path solve."""
    from fenics_eff_uptake.solvers.multilevel import build_multilevel
    _, bnd = systems
    mids = [generate_mesh(mesh_size=0.24, **KW),
            generate_mesh(mesh_size=0.45, **KW)]
    mus = np.array([0.1, 1.0, 10.0])
    D = np.ones(3)
    ml_g = build_multilevel(bnd, mids, D, mu_values=mus)
    assert ml_g.levels[0].bands is None
    monkeypatch.setenv("FEU_ML_TBAND", "1")
    ml_t = build_multilevel(bnd, mids, D, mu_values=mus)
    assert ml_t.levels[0].bands is not None
    X1, i1 = solve_sweep(bnd, D, mu_values=mus, rtol=1e-11,
                         precision="mixed", multilevel=ml_t,
                         chunk_iters=25)
    X2, _ = solve_sweep(bnd, D, mu_values=mus, rtol=1e-11,
                        precision="mixed", multilevel=ml_g,
                        chunk_iters=25)
    assert float(jnp.abs(X1 - X2).max()) < 1e-8
    assert (np.asarray(i1["rel_resnorm"]) < 1e-10).all()


def test_sweep_equivalence_tband_bf16(mesh, systems, monkeypatch):
    """bf16 transfer bands (FEU_ML_TB_BF16=1) change
    only the preconditioner's internal precision: the f64 defect
    correction still converges to rtol and the solution matches the f32
    gather-path solve.  Rounding P and P^T entrywise from the same
    values keeps restrict == prolong^T, so M stays CG-symmetric."""
    from fenics_eff_uptake.solvers.multilevel import build_multilevel
    _, bnd = systems
    mids = [generate_mesh(mesh_size=0.24, **KW),
            generate_mesh(mesh_size=0.45, **KW)]
    mus = np.array([0.1, 1.0, 10.0])
    D = np.ones(3)
    ml_g = build_multilevel(bnd, mids, D, mu_values=mus)
    monkeypatch.setenv("FEU_ML_TBAND", "1")
    monkeypatch.setenv("FEU_ML_TB_BF16", "1")
    ml_t = build_multilevel(bnd, mids, D, mu_values=mus)
    assert ml_t.levels[0].bands is not None
    X1, i1 = solve_sweep(bnd, D, mu_values=mus, rtol=1e-11,
                         precision="mixed", multilevel=ml_t,
                         chunk_iters=25)
    X2, _ = solve_sweep(bnd, D, mu_values=mus, rtol=1e-11,
                        precision="mixed", multilevel=ml_g,
                        chunk_iters=25)
    assert float(jnp.abs(X1 - X2).max()) < 1e-8
    assert (np.asarray(i1["rel_resnorm"]) < 1e-10).all()
