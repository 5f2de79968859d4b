"""Device-mesh sharding: sweep DP + element-partitioned operator TP.

The reference has no distributed execution (SURVEY.md 2.3); the scaling
axes here are:

  "sweep" (DP): independent sweep points (mu values / geometries) sharded
      across devices -- embarrassingly parallel, one jitted program.
  "cells" (TP analogue): the element loop of the operator partitioned
      across devices; each device computes the scatter of its cell chunk
      into a full dof vector and a psum over the "cells" axis assembles the
      global SpMV result.  This is how a mesh exceeding one device's
      memory is row-sharded.

Built on jax.sharding.Mesh + shard_map with explicit psum; XLA lowers
the collectives to NCCL on GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:
    from jax.experimental.shard_map import shard_map

from ..solvers.cg import cg

__all__ = ["make_device_mesh", "ShardedMuSweep", "build_sharded_mu_sweep"]


def make_device_mesh(n_devices: Optional[int] = None, tp: int = 1):
    """(sweep, cells) device mesh over the first n devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = np.array(devs[:n_devices])
    dp = n_devices // tp
    return Mesh(devs.reshape(dp, tp), axis_names=("sweep", "cells"))


def _pad_to(x, n, axis=0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge")


class ShardedMuSweep:
    """Sharded version of parallel.sweep: A(mu) = K + mu R, cells sharded.

    Element arrays (A_e, cell_dofs) are sharded along the cell axis over
    "cells"; dof vectors are replicated; each SpMV ends in a psum("cells").
    The mu batch is sharded over "sweep".
    """

    def __init__(self, mesh_dev: Mesh, sys, rtol=1e-12, maxiter=2000):
        self.mesh_dev = mesh_dev
        self.sys = sys
        self.rtol = rtol
        self.maxiter = maxiter
        self.tp = mesh_dev.shape["cells"]
        self.dp = mesh_dev.shape["sweep"]
        self._build()

    def _build(self):
        sys = self.sys
        tp = self.tp
        ndofs = sys.ndofs

        # shard the K and R element blocks along cells (pad to multiple).
        def shard_block(block):
            A_e = np.asarray(block.A_e)
            dofs = np.asarray(block.entity_dofs)
            n = A_e.shape[0]
            n_pad = ((n + tp - 1) // tp) * tp
            A_e = _pad_to(A_e, n_pad)
            dofs = _pad_to(dofs, n_pad)
            # padded duplicate entries contribute 0: zero their matrices
            if n_pad > n:
                A_e = A_e.copy()
                A_e[n:] = 0.0
            return jnp.asarray(A_e), jnp.asarray(dofs)

        (KA, Kd) = shard_block(sys.K_block)
        (RA, Rd) = shard_block(sys.R_block)
        free = sys.free
        g = sys.bc_values
        diagK, diagR = sys.diagK, sys.diagR
        rtol, maxiter = self.rtol, self.maxiter

        def local_apply(A_e, dofs, x):
            xe = x[dofs]
            ye = jnp.einsum("nij,nj->ni", A_e, xe)
            y = jnp.zeros_like(x)
            return y.at[dofs.reshape(-1)].add(ye.reshape(-1))

        def sharded_solve(mu_local, KA_l, Kd_l, RA_l, Rd_l):
            # mu_local: (B/dp,) on this shard
            def A_raw(mu, x):
                y = (local_apply(KA_l, Kd_l, x)
                     + mu * local_apply(RA_l, Rd_l, x))
                return jax.lax.psum(y, "cells")

            def A_op(mu, x):
                y = A_raw(mu, jnp.where(free, x, 0.0))
                return jnp.where(free, y, x)

            def solve_one(mu):
                Ag = A_raw(mu, g)                  # unconstrained A @ g_bc
                rhs = jnp.where(free, -Ag, g)
                diag = diagK + mu * diagR
                dinv = jnp.where(free & (jnp.abs(diag) > 0),
                                 1.0 / jnp.where(diag != 0, diag, 1.0), 1.0)
                res = cg(lambda x: A_op(mu, x), rhs, M=lambda r: dinv * r,
                         rtol=rtol, maxiter=maxiter)
                return res.x

            return jax.vmap(solve_one)(mu_local)

        mesh_dev = self.mesh_dev
        smap_kwargs = dict(
            mesh=mesh_dev,
            in_specs=(P("sweep"), P("cells"), P("cells"),
                      P("cells"), P("cells")),
            out_specs=P("sweep"),
        )
        try:
            smap = shard_map(sharded_solve, check_vma=False, **smap_kwargs)
        except TypeError:
            smap = shard_map(sharded_solve, check_rep=False, **smap_kwargs)
        self._fn = jax.jit(smap)
        self._args = (KA, Kd, RA, Rd)

    def solve(self, mu_values):
        """Solve for all mu; pads the batch to a multiple of the sweep axis."""
        mu = np.asarray(mu_values, dtype=np.float64)
        B = len(mu)
        B_pad = ((B + self.dp - 1) // self.dp) * self.dp
        mu_p = np.pad(mu, (0, B_pad - B), mode="edge")
        out = self._fn(jnp.asarray(mu_p), *self._args)
        return out[:B]


class _SweepSystemWithBlocks:
    """MuSweepSystem + raw blocks (needed for sharding)."""

    def __init__(self, mesh_data, D=1.0, element="P2"):
        from ..fem.assembly import (make_bc, robin_facet_block,
                                    stiffness_block)
        from ..fem.space import FunctionSpace
        from ..meshing.mesh_data import MARKERS
        space = FunctionSpace(mesh_data, element)
        self.K_block = stiffness_block(space, D=D)
        bottom = mesh_data.bc_marker == MARKERS["bottom"]
        self.R_block = robin_facet_block(space, bottom, mu=1.0)
        from ..ops.elemspmv import SumOperator
        K = SumOperator([self.K_block], space.ndofs)
        R = SumOperator([self.R_block], space.ndofs)
        bc = make_bc(space, [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)])
        self.diagK = K.diagonal()
        self.diagR = R.diagonal()
        self.free = bc.free
        self.bc_values = bc.values
        self.ndofs = space.ndofs
        self.space = space


def build_sharded_mu_sweep(mesh_data, device_mesh: Mesh, D=1.0,
                           element="P2", rtol=1e-12, maxiter=2000):
    sys = _SweepSystemWithBlocks(mesh_data, D=D, element=element)
    return ShardedMuSweep(device_mesh, sys, rtol=rtol, maxiter=maxiter)
