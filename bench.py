"""Headline benchmark: per-sweep-point assembly+solve wall-clock.

Runs the Phase-A mu parameter sweep workload (BASELINE.json config #2 /
SURVEY.md 3.5: 20 mu factors on the 0.25x0.25 mm sulcus at the reference's
default mesh h=0.02 -> ~50k triangles, ~1e5 P2 dofs) as ONE vmapped batched
solve and reports steady-state wall-clock per sweep point.

Baseline: the reference publishes no timings (BASELINE.md); its per-point
cost is one FEniCS assembly + sparse direct LU at ~1e5 CG2 dofs, which on
the reference's serial CPU setup is seconds-scale.  We use a conservative
2.0 s/point estimate for vs_baseline (documented assumption; the
BASELINE.json target is >=10x, i.e. <=0.2 s/point).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}; its
meta names the device (platform, device_kind, count, and the nvidia-smi
name and power limit where there is one).
"""

import json
import os
import sys
import time

import numpy as np

from fenics_eff_uptake.utils.device import device_info, nvidia_smi_name_power

REF_SECONDS_PER_POINT = 2.0  # assumed serial FEniCS assembly+LU per point
N_MU = 20
MESH_SIZE = float(os.environ.get("BENCH_MESH_SIZE", "0.02"))
PRECISION = os.environ.get("BENCH_PRECISION", None)  # default: auto
PRECOND = os.environ.get("BENCH_PRECOND", "ml")      # ml | twolevel


def run_bench():
    """Measure once; returns the result dict main() prints."""
    from fenics_eff_uptake.utils.jaxconfig import setup
    jax = setup(x64=True)

    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.parallel.sweep import (build_transport_system,
                                                      solve_sweep)
    from fenics_eff_uptake.studies.phase_a import MU_SWEEP_REGIMES

    kw = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
    t_mesh = time.time()
    mesh = generate_mesh(mesh_size=MESH_SIZE, **kw)
    if PRECOND == "ml":
        # nested P1-on-the-fine-mesh first level (exact embedding) +
        # coarser rediscretised P1 levels; see solvers/multilevel.py
        # level_meshes_for
        aux_meshes = [mesh,
                      generate_mesh(mesh_size=max(3 * MESH_SIZE, 0.06),
                                    **kw),
                      generate_mesh(mesh_size=max(9 * MESH_SIZE, 0.18),
                                    **kw)]
        if os.environ.get("FEU_ML_NESTED", "1") != "1":
            aux_meshes = aux_meshes[1:]
    else:
        aux_meshes = [generate_mesh(mesh_size=max(4 * MESH_SIZE, 0.08),
                                    **kw)]
    t_mesh = time.time() - t_mesh

    # first build includes one-time XLA compiles (persistently cached);
    # the second build measures the true steady per-sweep assembly cost
    t0 = time.time()
    sys_t = build_transport_system(mesh, element="P2")
    jax.block_until_ready(sys_t.K.A64)
    t_asm_cold = time.time() - t0
    t_asm = time.time()
    sys_t = build_transport_system(mesh, element="P2")
    jax.block_until_ready(sys_t.K.A64)
    t_asm = time.time() - t_asm

    mus = np.array([f for r in MU_SWEEP_REGIMES.values() for f in r],
                   dtype=np.float64)[:N_MU]
    D = np.ones_like(mus)

    rtol = 1e-11
    # preconditioner setup is part of the per-sweep cost; built once here
    t_tl = time.time()
    solver_kw = {}
    if PRECOND == "ml":
        from fenics_eff_uptake.solvers.multilevel import (
            build_multilevel)
        ml = build_multilevel(sys_t, aux_meshes, D, mu_values=mus)
        jax.block_until_ready(ml.Ainv)
        solver_kw["multilevel"] = ml
        solver_kw["chunk_iters"] = int(
            os.environ.get("BENCH_CHUNK", "50"))
    else:
        from fenics_eff_uptake.solvers.twolevel import build_twolevel
        tl = build_twolevel(sys_t, aux_meshes[0], D, mu_values=mus)
        jax.block_until_ready(tl.Ainv if tl.Ainv is not None
                              else tl.A0inv)
        solver_kw["twolevel"] = tl
    t_tl = time.time() - t_tl

    # warmup/compile
    t_compile = time.time()
    X, info = solve_sweep(sys_t, D, mu_values=mus, rtol=rtol,
                          precision=PRECISION, **solver_kw)
    jax.block_until_ready(X)
    t_compile = time.time() - t_compile

    # steady-state preconditioner setup: rebuild for the same geometry
    # with warm in-process program caches.  A study process pays the
    # one-time jit program loads once across its ~23 geometries, so the
    # steady per-sweep setup excludes them -- the same methodology as
    # the warm assembly above (cold numbers stay in meta).  Both steady
    # stages take the MIN of 3 repeats: steady-state cost is the
    # repeatable floor, not one sample of host and dispatch jitter.
    t_tl_warm = t_tl
    t_solve = None
    for _rep in range(3):
        if PRECOND == "ml":
            t0 = time.time()
            ml = build_multilevel(sys_t, aux_meshes, D, mu_values=mus)
            jax.block_until_ready(ml.Ainv)
            t_rep = time.time() - t0
            t_tl_warm = t_rep if _rep == 0 else min(t_tl_warm, t_rep)
            solver_kw["multilevel"] = ml

        # re-solve with perturbed mus to avoid caching the result
        t0 = time.time()
        X, info = solve_sweep(sys_t, D,
                              mu_values=mus * (1.0 + 1e-7 * (_rep + 1)),
                              rtol=rtol, precision=PRECISION, **solver_kw)
        jax.block_until_ready(X)
        t_rep = time.time() - t0
        t_solve = t_rep if t_solve is None else min(t_solve, t_rep)

    per_point = (t_asm + t_tl_warm + t_solve) / len(mus)
    meta = {
        "mesh_cells": int(mesh.num_cells),
        "ndofs": int(sys_t.ndofs),
        "n_sweep_points": int(len(mus)),
        "mesh_gen_s": round(t_mesh, 3),
        "assembly_s": round(t_asm, 3),
        "assembly_cold_s": round(t_asm_cold, 3),
        "twolevel_setup_s": round(t_tl_warm, 3),
        "twolevel_setup_cold_s": round(t_tl, 3),
        "first_solve_s": round(t_compile, 3),
        "steady_solve_s": round(t_solve, 3),
        "iters": np.asarray(info["iters"]).tolist(),
        "max_resnorm": float(np.max(info["resnorm"])),
        "max_rel_resnorm": float(np.max(info.get("rel_resnorm",
                                                 info["resnorm"]))),
        "preconditioner": PRECOND,
        "backend": jax.default_backend(),
        "device": device_info(),
        "nvidia_smi": nvidia_smi_name_power(),
        "assembled_dofs_per_s": (int(sys_t.ndofs / t_asm)
                                 if t_asm > 0 else None),
        # warm assembly roofline: modelled device bytes vs measured
        # wall-clock.  The achieved fraction being far below HBM peak
        # says warm assembly is host/dispatch-latency bound, not
        # bandwidth bound (utils/roofline.py assembly_cost docstring).
        "assembly_roofline": None,  # filled below
        "baseline_assumption_s_per_point": REF_SECONDS_PER_POINT,
        # the reference publishes no timings, so vs_baseline rests on the
        # 2.0 s/pt serial-FEniCS assumption (BASELINE.md "Defending the
        # baseline"); report the speedup under alternative assumptions and
        # the break-even baseline for the 10x target so the headline is
        # auditable rather than a single undefended constant
        "baseline_sensitivity": {
            "speedup_if_baseline_1.0s": round(1.0 / per_point, 2),
            "speedup_if_baseline_2.0s": round(2.0 / per_point, 2),
            "speedup_if_baseline_4.0s": round(4.0 / per_point, 2),
            "min_baseline_for_10x_s": round(10 * per_point, 3),
        },
        "banded_operator": sys_t.Kband is not None,
    }
    try:
        from fenics_eff_uptake.solvers.multilevel import CACHE_STATS
        meta["ml_transfer_cache"] = dict(CACHE_STATS)
    except ImportError:
        pass
    from fenics_eff_uptake.utils.roofline import (UnknownDeviceError,
                                                  assembly_cost, chip_peaks)
    try:
        pk = chip_peaks()
    except UnknownDeviceError as e:
        # no published peaks (e.g. the CPU): no roofline, and the reason
        pk = None
        meta["roofline"] = None
        meta["roofline_null_reason"] = str(e)
    if pk is not None:
        ac = assembly_cost(sys_t)
        gbps = ac["bytes"] / max(t_asm, 1e-12) / 1e9
        meta["assembly_roofline"] = {
            "modeled_bytes_mb": round(ac["bytes"] / 2**20, 1),
            "achieved_gbps": round(gbps, 2),
            "hbm_roofline_pct": round(100.0 * gbps / pk["hbm_gbps"], 2),
        }
    if PRECOND == "ml" and pk is not None:
        # roofline accounting: modelled bytes/FLOPs of the executed CG
        # iterations vs chip peaks (utils/roofline.py)
        try:
            from fenics_eff_uptake.solvers.multilevel import (
                _ml_cycle, _ml_smooth_steps)
            from fenics_eff_uptake.utils.roofline import (
                ml_cg_iteration_cost, roofline_summary)
            cycle = _ml_cycle()
            cost = ml_cg_iteration_cost(
                sys_t, ml, B=len(mus), n_smooth=_ml_smooth_steps(),
                cycle=cycle)
            meta["ml_cycle"] = cycle
            meta["roofline"] = roofline_summary(
                cost, iters_executed=int(np.max(info["iters"])),
                wall_s=t_solve, passes_f64=int(info.get("passes", 0)) + 1,
                sys_t=sys_t, B=len(mus), peaks=pk)
        except Exception as e:
            meta["roofline"] = {"error": f"{type(e).__name__}: {e}"}
    return {
        "metric": "assembly+solve wall-clock per sweep point "
                  "(20-mu batched sweep, ~1e5 P2 dofs)",
        "value": round(per_point, 4),
        "unit": "s/point",
        "vs_baseline": round(REF_SECONDS_PER_POINT / per_point, 2),
        "meta": meta,
    }


def main():
    print(json.dumps(run_bench()))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # always emit a line for the driver
        print(json.dumps({
            "metric": "assembly+solve wall-clock per sweep point",
            "value": None, "unit": "s/point", "vs_baseline": None,
            "error": f"{type(e).__name__}: {e}",
        }))
        sys.exit(1)
