"""Matrix-free element-operator application (the framework's SpMV).

The replacement for PETSc's assembled-CSR SpMV (ref: every
``solve(a == L)`` in solvers.py): the operator is kept as per-entity dense
element matrices ``A_e (N, nd, nd)`` plus the entity->dof map, and the action

    y = sum_e  P_e^T  A_e  P_e  x

is computed as  gather -> batched small matmul -> sorted segment-sum
scatter.  Unlike assembled CSR, this layout is fully regular (no indirection
of variable row lengths), which XLA tiles well; and the same arrays batch
trivially over parameter sweeps with ``vmap`` (coefficients live in A_e).
It is plain JAX, left to XLA's fusion on every backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Scatter", "ElementBlock", "SumOperator", "make_scatter"]


@dataclass(frozen=True)
class Scatter:
    """Precomputed sorted-scatter plan for one entity->dof map."""

    perm: jnp.ndarray         # (N*nd,) permutation sorting the flat dof ids
    ids_sorted: jnp.ndarray   # (N*nd,) sorted dof ids
    ndofs: int


def make_scatter(entity_dofs: np.ndarray, ndofs: int) -> Scatter:
    ids = np.asarray(entity_dofs).ravel()
    perm = np.argsort(ids, kind="stable")
    return Scatter(perm=jnp.asarray(perm, dtype=jnp.int32),
                   ids_sorted=jnp.asarray(ids[perm], dtype=jnp.int32),
                   ndofs=int(ndofs))


@dataclass
class ElementBlock:
    """One additive block of an operator: entity matrices + dof map."""

    A_e: jnp.ndarray          # (N, nd, nd)
    entity_dofs: jnp.ndarray  # (N, nd) int32
    scatter: Scatter

    @classmethod
    def build(cls, A_e, entity_dofs: np.ndarray, ndofs: int):
        return cls(A_e=A_e,
                   entity_dofs=jnp.asarray(entity_dofs, dtype=jnp.int32),
                   scatter=make_scatter(entity_dofs, ndofs))

    def apply(self, x):
        xe = x[self.entity_dofs]                      # (N, nd) gather
        ye = jnp.einsum("nij,nj->ni", self.A_e, xe,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=x.dtype)  # batched matmul
        vals = ye.reshape(-1)[self.scatter.perm]
        return jax.ops.segment_sum(
            vals, self.scatter.ids_sorted,
            num_segments=self.scatter.ndofs, indices_are_sorted=True)

    def diagonal(self):
        de = jnp.diagonal(self.A_e, axis1=1, axis2=2)  # (N, nd)
        vals = de.reshape(-1)[self.scatter.perm]
        return jax.ops.segment_sum(
            vals, self.scatter.ids_sorted,
            num_segments=self.scatter.ndofs, indices_are_sorted=True)

    def to_coo(self):
        """(rows, cols, vals) as NumPy -- for scipy cross-checks in tests."""
        ed = np.asarray(self.entity_dofs)
        N, nd = ed.shape
        rows = np.repeat(ed, nd, axis=1).ravel()
        cols = np.tile(ed, (1, nd)).ravel()
        vals = np.asarray(self.A_e).ravel()
        return rows, cols, vals


@dataclass
class RectBlock:
    """Rectangular element block: rows on one space, columns on another.

    Used for the Stokes divergence coupling B (pressure rows, velocity
    columns); ``apply`` computes B x_u, ``apply_t`` computes B^T x_p.
    """

    B_e: jnp.ndarray           # (N, nr, nc)
    row_dofs: jnp.ndarray      # (N, nr)
    col_dofs: jnp.ndarray      # (N, nc)
    row_scatter: Scatter
    col_scatter: Scatter

    @classmethod
    def build(cls, B_e, row_dofs, col_dofs, nrows: int, ncols: int):
        return cls(B_e=B_e,
                   row_dofs=jnp.asarray(row_dofs, dtype=jnp.int32),
                   col_dofs=jnp.asarray(col_dofs, dtype=jnp.int32),
                   row_scatter=make_scatter(row_dofs, nrows),
                   col_scatter=make_scatter(col_dofs, ncols))

    def apply(self, x):
        xe = x[self.col_dofs]
        ye = jnp.einsum("nij,nj->ni", self.B_e, xe,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=x.dtype)
        vals = ye.reshape(-1)[self.row_scatter.perm]
        return jax.ops.segment_sum(
            vals, self.row_scatter.ids_sorted,
            num_segments=self.row_scatter.ndofs, indices_are_sorted=True)

    def apply_t(self, x):
        xe = x[self.row_dofs]
        ye = jnp.einsum("nij,ni->nj", self.B_e, xe,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=x.dtype)
        vals = ye.reshape(-1)[self.col_scatter.perm]
        return jax.ops.segment_sum(
            vals, self.col_scatter.ids_sorted,
            num_segments=self.col_scatter.ndofs, indices_are_sorted=True)

    def to_coo(self):
        rd = np.asarray(self.row_dofs)
        cd = np.asarray(self.col_dofs)
        N, nr = rd.shape
        nc = cd.shape[1]
        rows = np.repeat(rd, nc, axis=1).ravel()
        cols = np.tile(cd, (1, nr)).ravel()
        vals = np.asarray(self.B_e).ravel()
        return rows, cols, vals


@dataclass
class SumOperator:
    """A = sum of element blocks (e.g. cell stiffness + boundary Robin)."""

    blocks: List[ElementBlock]
    ndofs: int

    def apply(self, x):
        y = jnp.zeros_like(x)
        for b in self.blocks:
            y = y + b.apply(x)
        return y

    def __call__(self, x):
        return self.apply(x)

    def diagonal(self):
        d = jnp.zeros(self.ndofs, dtype=self.blocks[0].A_e.dtype)
        for b in self.blocks:
            d = d + b.diagonal()
        return d

    def to_scipy(self):
        import scipy.sparse as sp
        rows, cols, vals = [], [], []
        for b in self.blocks:
            r, c, v = b.to_coo()
            rows.append(r)
            cols.append(c)
            vals.append(v)
        return sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.ndofs, self.ndofs)).tocsr()
