"""Device-side coarsest-level inverses (Newton-Schulz) vs LAPACK.

On accelerators the multigrid coarsest dense inverses are computed on
device by batched Newton-Schulz matmul iteration (solvers/multilevel.py
:_coarse_inverse_device) instead of host LAPACK + upload.  These tests
pin the NS inverses to the host np.linalg.inv reference for both the
scalar-mu and per-sample-Robin paths, on the real coarse systems the
V-cycle uses.
"""

import numpy as np

from fenics_eff_uptake.meshing.generator import generate_mesh
from fenics_eff_uptake.parallel.sweep import build_transport_system
from fenics_eff_uptake.solvers.multilevel import (
    _coarse_inverse_device)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")


def _host_inverses(csys, D, mu, Rb=None):
    nc = csys.ndofs

    def dense_of(block, A_e):
        M = np.zeros((nc, nc))
        dofs = np.asarray(block.dofs)
        Ae = np.asarray(A_e)
        for li in range(dofs.shape[1]):
            for lj in range(dofs.shape[1]):
                np.add.at(M, (dofs[:, li], dofs[:, lj]), Ae[:, li, lj])
        return M

    free = np.asarray(csys.free)

    def constrain(A):
        A[~free, :] = 0.0
        A[:, ~free] = 0.0
        idx = np.flatnonzero(~free)
        A[idx, idx] = 1.0
        return A

    K = constrain(dense_of(csys.K, csys.K.A64))
    R = (constrain(dense_of(csys.R, csys.R.A64))
         if csys.R is not None else None)
    out = []
    for b in range(len(D)):
        A = D[b] * K
        if R is not None:
            if Rb is not None:
                A = A + constrain(dense_of(csys.R, Rb[b]))
            else:
                A = A + mu[b] * R
        A = A + 1e-6 * np.abs(np.diag(A)).mean() * np.eye(nc)
        out.append(np.linalg.inv(A.astype(np.float32)))
    return np.stack(out)


def _coarse_system():
    mesh = generate_mesh(mesh_size=0.18, **KW)
    return build_transport_system(mesh, element="P1", pad_shapes=True,
                                  pad_granularity=(256, 1024, 128))


def test_ns_inverse_matches_lapack_scalar_mu():
    csys = _coarse_system()
    B = 6
    D = np.linspace(0.5, 2.0, B)
    mu = np.linspace(0.1, 150.0, B)
    ref = _host_inverses(csys, D, mu)
    got = np.asarray(_coarse_inverse_device(csys, D, mu, None))
    assert got.shape == ref.shape
    # both are f32 inverses of the same matrices
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 2e-3 * scale


def test_ns_inverse_matches_lapack_per_sample_robin():
    csys = _coarse_system()
    B = 4
    D = np.ones(B)
    mu = np.zeros(B)
    base = np.asarray(csys.R.A64)
    scales = np.linspace(0.5, 3.0, B)
    Rb = np.stack([s * base for s in scales])
    ref = _host_inverses(csys, D, mu, Rb=Rb)
    got = np.asarray(_coarse_inverse_device(
        csys, D, mu, np.asarray(Rb, dtype=np.float32)))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 2e-3 * scale
