"""FEM core tests: element matrices, assembly vs scipy, MMS convergence.

This is the unit layer of the test pyramid described in SURVEY.md section 4
(the reference has no tests; analytic element matrices and
method-of-manufactured-solutions convergence are our correctness bedrock).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fenics_eff_uptake.fem.assembly import (
    constrained_operator, constrained_rhs, load_vector, make_bc, mass_block,
    robin_facet_block, stiffness_block)
from fenics_eff_uptake.fem.elements import tabulate, tabulate_grad
from fenics_eff_uptake.fem.quadrature import triangle_rule
from fenics_eff_uptake.fem.space import FunctionSpace
from fenics_eff_uptake.analysis.integrals import l2_error
from fenics_eff_uptake.meshing.generator import structured_rectangle
from fenics_eff_uptake.meshing.mesh_data import MARKERS
from fenics_eff_uptake.models.diffusion import (build_diffusion_system,
                                                    pure_diffusion_solve)
from fenics_eff_uptake.ops.elemspmv import SumOperator
from fenics_eff_uptake.solvers.cg import cg, jacobi_preconditioner


def test_partition_of_unity_and_gradients():
    pts = np.random.RandomState(0).rand(20, 2) * 0.5
    for elem in ("P1", "P2"):
        phi = tabulate(elem, pts)
        assert np.allclose(phi.sum(1), 1.0, atol=1e-13)
        g = tabulate_grad(elem, pts)
        assert np.allclose(g.sum(1), 0.0, atol=1e-12)
        # finite-difference check of gradients
        eps = 1e-7
        for d in range(2):
            shift = np.zeros(2)
            shift[d] = eps
            fd = (tabulate(elem, pts + shift) - tabulate(elem, pts - shift)) / (2 * eps)
            assert np.allclose(g[:, :, d], fd, atol=1e-6)


def test_quadrature_exactness():
    # integrate x^a y^b over reference triangle: a! b! / (a+b+2)!
    from math import factorial
    for deg in (1, 2, 3, 4, 5, 6):
        qp, qw = triangle_rule(deg)
        for a in range(deg + 1):
            for b in range(deg + 1 - a):
                exact = (factorial(a) * factorial(b)) / factorial(a + b + 2)
                approx = (qw * qp[:, 0] ** a * qp[:, 1] ** b).sum()
                assert abs(approx - exact) < 1e-14, (deg, a, b)


def test_p1_stiffness_unit_triangle():
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    cells = np.array([[0, 1, 2]])
    from fenics_eff_uptake.meshing.markers import build_mesh_data
    from fenics_eff_uptake.meshing.geometry import SulcusGeometry
    geom = SulcusGeometry(1.0, 1.0, 0.0, 0.0, 1.0)
    md = build_mesh_data(verts, cells, geom, "rectangular")
    sp = FunctionSpace(md, "P1")
    K = np.asarray(stiffness_block(sp).A_e[0])
    K_exact = 0.5 * np.array([[2.0, -1.0, -1.0],
                              [-1.0, 1.0, 0.0],
                              [-1.0, 0.0, 1.0]])
    assert np.allclose(K, K_exact, atol=1e-14)
    M = np.asarray(mass_block(sp).A_e[0])
    M_exact = (1.0 / 24.0) * np.array([[2.0, 1.0, 1.0],
                                       [1.0, 2.0, 1.0],
                                       [1.0, 1.0, 2.0]])
    assert np.allclose(M, M_exact, atol=1e-15)


def test_operator_matches_scipy():
    md = structured_rectangle(2.0, 1.0, 6, 3)
    sp = FunctionSpace(md, "P2")
    op = SumOperator([stiffness_block(sp),
                      robin_facet_block(sp, md.bc_marker == MARKERS["bottom"],
                                        mu=0.7)], sp.ndofs)
    A = op.to_scipy()
    rng = np.random.RandomState(1)
    x = rng.randn(sp.ndofs)
    y_op = np.asarray(op.apply(jnp.asarray(x)))
    y_sp = A @ x
    assert np.allclose(y_op, y_sp, atol=1e-12)
    # diagonal
    assert np.allclose(np.asarray(op.diagonal()), A.diagonal(), atol=1e-12)


def test_linear_solution_exact():
    """mu=0: c = 1 - x/L is in both P1 and P2 spaces -> exact solve."""
    md = structured_rectangle(2.0, 1.0, 8, 4)
    for elem in ("P1", "P2"):
        c = pure_diffusion_solve(md, D=1.0, mu=0.0, element=elem)
        exact = 1.0 - np.asarray(c.space.dof_coords)[:, 0] / 2.0
        assert np.allclose(c.as_numpy(), exact, atol=1e-10), elem
        assert c.solver_info["converged"]


def test_cg_vs_scipy_direct_with_robin():
    """CG solution of the diffusion+Robin system matches scipy splu."""
    import scipy.sparse.linalg as spla
    md = structured_rectangle(2.0, 1.0, 10, 5)
    sp = FunctionSpace(md, "P2")
    sys = build_diffusion_system(sp, D=1.0, mu=2.0)
    res = cg(sys.apply, sys.rhs, M=sys.precond, rtol=1e-14)
    A = sys.op.to_scipy().tolil()
    free = np.asarray(sys.bc.free)
    vals = np.asarray(sys.bc.values)
    b = -A @ vals
    for i in np.flatnonzero(~free):
        A[i, :] = 0.0
        A[:, i] = 0.0
        A[i, i] = 1.0
        b[i] = vals[i]
    b[~free] = vals[~free]
    # also zero column contribution already handled by b = -A@vals on free
    x_direct = spla.spsolve(A.tocsc(), b)
    assert np.allclose(np.asarray(res.x), x_direct, atol=1e-9)


@pytest.mark.parametrize("elem,rate", [("P1", 2.0), ("P2", 3.0)])
def test_mms_convergence(elem, rate):
    """-lap u = f, u = sin(pi x) sin(pi y) on [0,1]^2, Dirichlet everywhere."""
    def u_ex(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    def f(x, y):
        return 2 * np.pi ** 2 * np.sin(np.pi * x) * np.sin(np.pi * y)

    errs = []
    hs = []
    for n in (4, 8, 16):
        md = structured_rectangle(1.0, 1.0, n, n)
        sp = FunctionSpace(md, elem)
        op = SumOperator([stiffness_block(sp)], sp.ndofs)
        bc = make_bc(sp, [(m, 0.0) for m in (1, 2, 3, 4)])
        b = load_vector(sp, f, degree=6)
        apply = constrained_operator(op, bc)
        rhs = constrained_rhs(op, bc, b)
        pre = jacobi_preconditioner(op.diagonal(), bc.free)
        res = cg(apply, rhs, M=pre, rtol=1e-14)
        errs.append(l2_error(sp, res.x, u_ex))
        hs.append(1.0 / n)
    rates = np.diff(np.log(errs)) / np.diff(np.log(hs))
    assert rates.min() > rate - 0.25, (errs, rates)
