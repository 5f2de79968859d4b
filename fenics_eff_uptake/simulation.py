"""End-to-end simulation orchestrator.

JAX equivalent of the reference's ``run_simulation``
(simulation.py:270-349): mesh -> velocity -> concentration -> metrics ->
(optional plots/ParaView) -> JSON, with the same output directory layout

  <results_root>/<Mode> Simulations/<study>/<config>/
      {Mesh Files, ParaView Files, Analysis Plots, Results Data}

and the same results dict keys.  Differences by design:
  - meshes are cached in-process by geometry key (the reference re-runs
    Gmsh for every simulation);
  - per-stage timers + solver iteration counts are recorded (SURVEY 5.1);
  - plotting/export are flags (non-interactive studies don't pay for them).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from .analysis.flux import compute_flux_metrics
from .analysis.mass import compute_mass_metrics
from .analysis.mu_eff import compute_mu_eff_metrics
from .analysis.profiles import compute_velocity_metrics
from .meshing.generator import generate_mesh
from .meshing.mesh_data import MeshData
from .models.advdiff import advdiff_solve
from .models.diffusion import pure_diffusion_solve
from .models.stokes_flow import stokes_solve, stokes_zero_fields
from .params import Parameters
from .utils.timers import StageTimer

__all__ = ["run_simulation", "get_mesh", "get_coarse_mesh", "clear_mesh_cache"]

MODE_NAME = {
    "adv-diff": "Adv-Diff",
    "no-adv": "No Advection",
    "no-uptake": "No Uptake",
}

_MESH_CACHE: Dict[tuple, MeshData] = {}


def clear_mesh_cache():
    _MESH_CACHE.clear()


def get_mesh(params: Parameters, domain_type: str,
             coarsen: float = 1.0) -> MeshData:
    """Generate (or fetch cached) mesh for the given parameters.

    coarsen > 1 produces the matching coarse mesh (same geometry, h scaled)
    used by the two-level preconditioner (solvers/twolevel.py).
    """
    gp = params.get_mesh_generator_params()
    if coarsen != 1.0:
        gp = dict(gp)
        gp["mesh_size"] = gp["mesh_size"] * coarsen
        gp["refinement_factor"] = 1
    key = (domain_type, gp["width"], gp["height"], gp["sulcus_depth"],
           gp["sulcus_width"], gp["mesh_size"], gp["refinement_factor"])
    if key not in _MESH_CACHE:
        _MESH_CACHE[key] = generate_mesh(domain_type=domain_type, **gp)
    return _MESH_CACHE[key]


def get_coarse_mesh(params: Parameters, domain_type: str,
                    threshold=0.08, factor=4.0):
    """Coarse companion mesh for preconditioning, or None if the fine mesh
    is already coarse enough that Jacobi alone is fine."""
    if params.mesh_size >= threshold:
        return None
    return get_mesh(params, domain_type, coarsen=factor)


def _save_paraview(mesh, u, p, c, paraview_dir):
    from .utils.vtk import (write_vtk_cell_scalar, write_vtk_point_scalar,
                            write_vtk_point_vector)
    os.makedirs(paraview_dir, exist_ok=True)
    write_vtk_cell_scalar(os.path.join(paraview_dir, "mesh_domains.vtk"),
                          mesh, mesh.cell_domain, name="domain")
    if u is not None:
        write_vtk_point_vector(os.path.join(paraview_dir, "velocity.vtk"), u)
    if p is not None:
        write_vtk_point_scalar(os.path.join(paraview_dir, "pressure.vtk"),
                               p, name="p")
    write_vtk_point_scalar(os.path.join(paraview_dir, "concentration.vtk"),
                           c, name="c")


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def run_simulation(mode, study_type, config_name, domain_type,
                   params: Parameters, mu_variable=False,
                   results_root="Results", save_outputs=True, plot=False,
                   save_paraview=False, verbose=True):
    """Run one simulation end-to-end; returns the results dict.

    Matches ref simulation.py:270-349 in behaviour and output layout.
    """
    start = time.time()
    timer = StageTimer()

    if mode not in ("adv-diff", "no-adv", "no-uptake"):
        raise ValueError(f"Invalid mode '{mode}'")
    if domain_type not in ("sulcus", "rectangular"):
        raise ValueError(f"Invalid domain type '{domain_type}'")

    base = os.path.join(results_root, f"{MODE_NAME[mode]} Simulations",
                        study_type, config_name)
    dirs = {name: os.path.join(base, name)
            for name in ("Mesh Files", "ParaView Files",
                         "Analysis Plots", "Results Data")}
    if save_outputs:
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)

    # 1) mesh
    with timer.stage("mesh"):
        mesh = get_mesh(params, domain_type)
    mesh_results = {"mesh": mesh, "mesh_info": mesh.mesh_info(),
                    "bc_markers": mesh.bc_marker}
    if domain_type == "sulcus":
        mesh_results.update({
            "bottom_segment_markers": mesh.bottom_marker,
            "y0_markers": mesh.y0_marker,
            "domain_markers": mesh.cell_domain,
        })
    if verbose:
        mi = mesh.mesh_info()
        print(f"[{config_name}] mesh: {mi['num_vertices']} vertices, "
              f"{mi['num_cells']} cells, h in "
              f"[{mi['hmin']:.4g}, {mi['hmax']:.4g}]")

    # 2) velocity (ref simulation.py:122-140)
    with timer.stage("stokes"):
        if mode == "no-adv":
            u, p = stokes_zero_fields(mesh)
        else:
            u, p = stokes_solve(mesh, H=params.H)
    u_for_transport = None if mode == "no-adv" else u

    # 3) concentration (ref simulation.py:142-166)
    with timer.stage("transport"):
        coarse = get_coarse_mesh(params, domain_type)
        if mode == "no-adv":
            c = pure_diffusion_solve(mesh, D=params.D, mu=params.mu,
                                     coarse_mesh=coarse)
        else:
            c = advdiff_solve(mesh, u, D=params.D, mu=params.mu,
                              coarse_mesh=coarse)
    if verbose and hasattr(c, "solver_info"):
        arr = c.as_numpy()
        print(f"[{config_name}] transport solve: {c.solver_info}; "
              f"c stats: min={arr.min():.6e} max={arr.max():.6e} "
              f"mean={arr.mean():.6e}")

    # 4) metrics (ref simulation.py:168-233)
    with timer.stage("metrics"):
        flux_metrics = compute_flux_metrics(
            c, u_for_transport, mesh, domain_type, params.D, params.mu,
            warn=verbose)
        mass_metrics = compute_mass_metrics(c, mesh, domain_type)
        vel_metrics = compute_velocity_metrics(u_for_transport, mesh, params)

    results = {
        "c": c, "u": u, "p": p,
        "mass_metrics": mass_metrics,
        "flux_metrics": flux_metrics,
        "vel_metrics": vel_metrics,
        "params": params,
        "mesh_results": mesh_results,
        "domain_type": domain_type,
        "timings": timer.summary(),
    }
    if domain_type == "sulcus":
        with timer.stage("mu_eff"):
            results["mu_eff_comparison"] = compute_mu_eff_metrics(
                c, mesh, params, flux_metrics)

    # 5) optional plots
    if plot and save_outputs:
        with timer.stage("plot"):
            from .plotting.single import plot_single_simulation
            plot_single_simulation(results, dirs["Analysis Plots"])

    # 6) exports (mesh artifacts: own .msh + .npz instead of the
    # reference's .geo/.msh/.xml triple, ref mesh.py:121-132)
    if save_outputs:
        with timer.stage("mesh_io"):
            from .meshing.msh_io import write_msh2
            base_name = ("sulcus_mesh" if domain_type == "sulcus"
                         else "rect_mesh")
            write_msh2(os.path.join(dirs["Mesh Files"],
                                    base_name + ".msh"),
                       mesh.vertices, mesh.cells)
            np.savez_compressed(
                os.path.join(dirs["Mesh Files"], base_name + ".npz"),
                vertices=mesh.vertices, cells=mesh.cells,
                cell_domain=mesh.cell_domain,
                bc_marker=mesh.bc_marker,
                bottom_marker=mesh.bottom_marker,
                y0_marker=mesh.y0_marker)
    if save_paraview and save_outputs:
        with timer.stage("paraview"):
            _save_paraview(mesh, u, p, c, dirs["ParaView Files"])
            from .meshing.visualization import save_mesh_visualization
            save_mesh_visualization(mesh, dirs["ParaView Files"])
    if save_outputs:
        results_file = os.path.join(dirs["Results Data"],
                                    "simulation_results.json")
        serializable = {
            "params": params.to_dict(),
            "mass_metrics": mass_metrics,
            "flux_metrics": _strip_private(flux_metrics),
            "mesh_info": mesh.mesh_info(),
            "mu_eff_comparison": results.get("mu_eff_comparison", None),
            "timings": timer.summary(),
        }
        with open(results_file, "w") as f:
            json.dump(serializable, f, indent=4, default=_json_default)

    results["timings"] = timer.summary()
    if verbose:
        print(f"[{config_name}] done in {time.time() - start:.2f}s "
              f"({results['timings']})")
    return results


def _strip_private(d):
    if isinstance(d, dict):
        return {k: _strip_private(v) for k, v in d.items()
                if not k.startswith("_")}
    return d
