"""Shared study-driver machinery.

The reference drivers run every sweep cell as a fresh serial FEniCS pipeline
(mesh -> assemble -> LU -> metrics; SURVEY.md section 3.3-3.5).  Here the
workhorse is ``no_adv_batch``: one mesh, one operator build, ONE vmapped
batched CG over all mu values of that geometry (parallel/sweep.py), then
per-mu metric extraction -- the data-parallel axis.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..fem.space import Function, FunctionSpace
from ..meshing.mesh_data import MeshData
from ..models.stokes_flow import stokes_solve
from ..params import Parameters
from ..parallel.sweep import build_transport_system, solve_sweep
from ..simulation import get_coarse_mesh, get_mesh

__all__ = ["make_no_adv_params", "no_adv_batch", "create_study_dirs",
           "save_csv", "csv_columns", "save_metadata", "shard_spec",
           "use_shard_devices", "sharded_stokes_or_single",
           "transport_batch"]


def shard_spec():
    """FEU_SHARD=<ndev> (+ FEU_SHARD_TP=<tp>, default 2) routes study
    transport solves through the production shard_map path
    (parallel/sharded_solve.py): sweep x cells device mesh, cells-
    partitioned operator + psum, MG preconditioner under shard_map.
    Returns (n_devices, tp) or None.  Study drivers expose this as
    --shard/--tp (use_shard_devices)."""
    v = os.environ.get("FEU_SHARD")
    if not v or v == "0":
        return None
    return int(v), int(os.environ.get("FEU_SHARD_TP", "2"))


def use_shard_devices(n, tp):
    """Route this process's study solves over an n-device mesh (the
    drivers' --shard N --tp K).  Uses the devices JAX already has and
    raises if fewer than n exist; it never changes platform.  (Virtual
    CPU devices are a test fixture: tests/conftest.py.)"""
    import jax
    have = len(jax.devices())
    if have < n:
        raise RuntimeError(
            f"--shard {n} needs {n} devices; {jax.default_backend()} "
            f"has {have}")
    if n % tp:
        raise ValueError(f"--tp {tp} does not divide --shard {n}")
    os.environ["FEU_SHARD"] = str(n)
    os.environ["FEU_SHARD_TP"] = str(tp)


def _sharded_batch_solve(mesh, D_batch, mus, rtol, maxiter, nd, tp):
    """One geometry's mu batch through sharded_solve_sweep; the sweep
    batch is padded up to a multiple of the data-parallel degree and
    sliced back.  Returns (X (B, ndofs) in space layout, info, space)."""
    from ..parallel.sharded_solve import (build_sharded_system,
                                          sharded_solve_sweep)
    from ..parallel.sharding import make_device_mesh
    from ..solvers.multilevel import build_multilevel_for

    # unpadded shapes: the sharded operator partitions raw cell/dof
    # counts across devices (tests/test_parallel.py pins this path)
    sys_t = build_transport_system(mesh, element="P2", pad_shapes=False)
    B = len(mus)
    dp = max(nd // tp, 1)
    Bp = ((B + dp - 1) // dp) * dp
    mus_p = list(mus) + [mus[-1]] * (Bp - B)
    D_p = list(D_batch) + [D_batch[-1]] * (Bp - B)
    # the MG coarse inverses are per-sample: build at the PADDED batch
    ml = build_multilevel_for(sys_t, mesh, D_p, mu_values=mus_p)
    dev_mesh = make_device_mesh(nd, tp=tp)
    ss = build_sharded_system(sys_t, dev_mesh, multilevel=ml)
    X, info = sharded_solve_sweep(ss, D_p, mus_p, rtol=rtol,
                                  chunk_iters=20, maxiter=maxiter)
    info = {k: v[:B] for k, v in info.items()}
    return X[:B], info, sys_t.space


def make_no_adv_params(mu_factor=1.0, sulci_w_dim=None, sulci_h_dim=None,
                       mesh_size_dim=None, **overrides) -> Parameters:
    """No-advection Parameters with mu_dim = baseline * factor
    (ref no_advection_analysis_B.py:43-53)."""
    p = Parameters(mode="no-adv", **overrides)
    if sulci_w_dim is not None:
        p.sulci_w_dim = sulci_w_dim
    if sulci_h_dim is not None:
        p.sulci_h_dim = sulci_h_dim
    if mesh_size_dim is not None:
        p.mesh_size_dim = mesh_size_dim
    p.mu_dim = Parameters.MU_DIM_NO_ADV * float(mu_factor)
    p.validate()
    p.nondim()
    return p


def no_adv_batch(geom_params: Parameters, mu_factors: List[float],
                 domain_type: str, rtol=1e-12, maxiter=50000,
                 verbose=True) -> List[Dict]:
    """Run the pure-diffusion problem for several mu* values on one mesh.

    Returns one results dict per mu factor with the same keys as
    ``run_simulation`` (c, mass_metrics, flux_metrics, params,
    mu_eff_comparison for sulcus domains).
    """
    t0 = time.time()
    mesh = get_mesh(geom_params, domain_type)
    # nondimensional mu* values for this sweep
    scale = geom_params.H_dim / geom_params.D_dim
    mus = [Parameters.MU_DIM_NO_ADV * f * scale for f in mu_factors]
    D_batch = [geom_params.D] * len(mus)
    shard = shard_spec()
    if shard is not None:
        X, info, space = _sharded_batch_solve(
            mesh, D_batch, mus, rtol, maxiter, *shard)
    else:
        sys = build_transport_system(mesh, element="P2")
        from ..solvers.multilevel import build_multilevel_for
        ml = build_multilevel_for(sys, mesh, D_batch, mu_values=mus)
        X, info = solve_sweep(sys, D_batch, mu_values=mus, rtol=rtol,
                              maxiter=maxiter, multilevel=ml)
        space = sys.space
    if verbose:
        print(f"  [batch] {domain_type} "
              f"w={geom_params.sulci_w_dim} h={geom_params.sulci_h_dim}: "
              f"{len(mus)} solves in {time.time() - t0:.2f}s "
              f"(iters={info['iters'].tolist()}"
              + (f", shard={shard}" if shard else "") + ")")
    params_list = [
        make_no_adv_params(
            f, sulci_w_dim=geom_params.sulci_w_dim,
            sulci_h_dim=geom_params.sulci_h_dim,
            mesh_size_dim=geom_params.mesh_size_dim,
            L_dim=geom_params.L_dim, H_dim=geom_params.H_dim,
            refinement_factor=geom_params.refinement_factor)
        for f in mu_factors]

    # batched metrics: ONE jitted dispatch for all sweep columns instead
    # of the per-run engine's eager dispatches
    from ..analysis.batched_metrics import (build_sweep_metrics,
                                            metrics_to_dicts)
    import jax.numpy as jnp
    t1 = time.time()
    sm = build_sweep_metrics(space, mesh, D=geom_params.D)
    t2 = time.time()
    flux_list, mass_list, mueff_list = metrics_to_dicts(
        sm, mesh, jnp.asarray(X), mus, geom_params.D, params_list)
    if verbose and os.environ.get("FEU_STUDY_TIMERS"):
        print(f"    [timers] solve={t1 - t0:.2f}s metrics_build="
              f"{t2 - t1:.2f}s metrics_dispatch={time.time() - t2:.2f}s")

    out = []
    for i, f in enumerate(mu_factors):
        c = Function(space, X[i])
        res = {
            "c": c, "u": None, "p": None,
            "mass_metrics": mass_list[i],
            "flux_metrics": flux_list[i],
            "vel_metrics": {},
            "params": params_list[i],
            "mesh_results": {"mesh": mesh, "mesh_info": mesh.mesh_info()},
            "domain_type": domain_type,
            "solver": {"iters": int(info["iters"][i]),
                       "resnorm": float(info["resnorm"][i])},
        }
        if domain_type == "sulcus":
            res["mu_eff_comparison"] = mueff_list[i]
        out.append(res)
    return out


def sharded_stokes_or_single(mesh, H):
    """Stokes solve, routed through the sharded saddle path when
    FEU_SHARD is set (parallel/sharded_solve.py build_sharded_stokes;
    same (sweep x cells) device mesh as the transport solves)."""
    sh = shard_spec()
    if sh is None:
        return stokes_solve(mesh, H=H)
    from ..parallel.sharded_solve import (build_sharded_stokes,
                                          sharded_stokes_solve)
    from ..parallel.sharding import make_device_mesh
    nd, tp = sh
    sst = build_sharded_stokes(mesh, H=H,
                               device_mesh=make_device_mesh(nd, tp=tp))
    u, p, _info = sharded_stokes_solve(sst, rtol=1e-9, chunk_iters=40)
    return u, p


def transport_batch(mesh, u, D_batch, mu_batch=None, steps=None,
                    rtol=1e-12, precision=None):
    """One domain's Pe x mu transport batch: vmapped BiCGStab on a
    single device, or the (sweep x cells) sharded path under FEU_SHARD.

    Either ``mu_batch`` (uniform-mu columns) or ``steps`` (per-sample
    step-mu(x) callables -> Robin entity-matrix batches, built here so
    they share the solve system's facet padding) selects the Robin
    treatment.  Returns (X (B, ndofs), info, sys).
    """
    import jax.numpy as jnp
    from ..parallel.sweep import robin_matrices_for_mu
    from ..solvers.multilevel import build_multilevel_for
    sh = shard_spec()
    B = len(D_batch)

    def _steps_R(sys_t):
        return jnp.asarray(np.stack(
            [np.asarray(robin_matrices_for_mu(sys_t, s)) for s in steps]))

    if sh is None:
        sys_t = build_transport_system(mesh, u_values=u.values,
                                       u_space=u.space)
        R_batch = None if steps is None else _steps_R(sys_t)
        if R_batch is None:
            ml = build_multilevel_for(sys_t, mesh, D_batch,
                                      mu_values=mu_batch, u_fine=u)
            X, info = solve_sweep(sys_t, D_batch, mu_values=mu_batch,
                                  rtol=rtol, precision=precision,
                                  multilevel=ml)
        else:
            ml = build_multilevel_for(sys_t, mesh, D_batch,
                                      mu_callables=steps,
                                      robin_matrices_fine=R_batch,
                                      u_fine=u)
            X, info = solve_sweep(sys_t, D_batch, robin_matrices=R_batch,
                                  rtol=rtol, precision=precision,
                                  multilevel=ml)
        return X, info, sys_t

    from ..parallel.sharded_solve import (build_sharded_system,
                                          sharded_solve_sweep)
    from ..parallel.sharding import make_device_mesh
    import jax.numpy as jnp
    nd, tp = sh
    dp = max(nd // tp, 1)
    Bp = ((B + dp - 1) // dp) * dp
    D_p = list(D_batch) + [D_batch[-1]] * (Bp - B)
    sys_t = build_transport_system(mesh, u_values=u.values,
                                   u_space=u.space, pad_shapes=False)
    R_batch = None if steps is None else _steps_R(sys_t)
    if R_batch is None:
        mu_p = list(mu_batch) + [mu_batch[-1]] * (Bp - B)
        ml = build_multilevel_for(sys_t, mesh, D_p, mu_values=mu_p,
                                  u_fine=u)
        ss = build_sharded_system(sys_t, make_device_mesh(nd, tp=tp),
                                  multilevel=ml)
        X, info = sharded_solve_sweep(ss, D_p, mu_p, rtol=rtol,
                                      chunk_iters=20, maxiter=50000)
    else:
        Rb = np.asarray(R_batch)
        Rb_p = np.concatenate(
            [Rb] + [Rb[-1:]] * (Bp - B), axis=0) if Bp > B else Rb
        steps_p = list(steps) + [steps[-1]] * (Bp - B)
        ml = build_multilevel_for(sys_t, mesh, D_p,
                                  mu_callables=steps_p,
                                  robin_matrices_fine=jnp.asarray(Rb_p),
                                  u_fine=u)
        ss = build_sharded_system(sys_t, make_device_mesh(nd, tp=tp),
                                  multilevel=ml, robin_batch=Rb_p)
        X, info = sharded_solve_sweep(ss, D_p, np.zeros(Bp), rtol=rtol,
                                      chunk_iters=20, maxiter=50000)
    info = {k: np.asarray(v)[:B] for k, v in info.items()}
    return X[:B], info, sys_t


def create_study_dirs(study_name, base_dir):
    """<base>/<study> Analysis + <base>/<study> Simulations
    (ref plotting.py:241-247)."""
    study_dir = os.path.join(base_dir, f"{study_name} Analysis")
    sim_dir = os.path.join(base_dir, f"{study_name} Simulations")
    os.makedirs(study_dir, exist_ok=True)
    os.makedirs(sim_dir, exist_ok=True)
    return study_dir, sim_dir


def csv_columns(rows):
    """Union of the rows' keys in order of first appearance."""
    return list(dict.fromkeys(k for r in rows for k in r))


def _is_missing(v):
    return v is None or (isinstance(v, (float, np.floating))
                         and np.isnan(v))


def _float_columns(rows, columns):
    """Columns a DataFrame would hold as float64: every value a number
    (bools excluded), at least one of them a float or missing."""
    out = set()
    for c in columns:
        vals = [r.get(c) for r in rows]
        numeric = all(
            _is_missing(v) or (isinstance(v, (int, float, np.integer,
                                              np.floating))
                               and not isinstance(v, (bool, np.bool_)))
            for v in vals)
        if numeric and any(_is_missing(v) or isinstance(
                v, (float, np.floating)) for v in vals):
            out.add(c)
    return out


def save_csv(rows, path, sort_by=None, columns=None):
    """Write row dicts as CSV with the stdlib csv module.

    The layout is what pandas' DataFrame(rows).to_csv(index=False)
    writes: columns in order of first appearance (or ``columns``),
    missing values and NaN as empty cells, whole numbers in a float
    column as floats.  sort_by: column names, a stable ascending sort.
    Returns the rows in written order."""
    import csv
    columns = list(columns or csv_columns(rows))
    if sort_by:
        rows = sorted(rows, key=lambda r: tuple(r[k] for k in sort_by))
    as_float = _float_columns(rows, columns)

    def cell(c, v):
        if _is_missing(v):
            return ""
        if c in as_float:
            return repr(float(v))
        return str(v)

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([cell(c, r.get(c)) for c in columns])
    print(f"  CSV saved: {path} ({len(rows)} rows)")
    return rows


def save_metadata(meta: dict, path: str):
    import json
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=str)
