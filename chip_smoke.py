#!/usr/bin/env python
"""Bring-up smoke run of the sweep and transport studies on NVIDIA GPUs.

    python chip_smoke.py                # one card: Phases A and B
    python chip_smoke.py --devices 4    # four cards: the sharded paths only

Everything runs in this one process: a JAX process reserves most of a
card's memory, so no child process opens the card.  The run refuses to
start unless JAX's first device is a GPU.  At the reference resolution
h = 0.02 it drives the studies through their normal entry points:

  Phase A  the symmetric mu sweep (studies.phase_a.run_mu_sweep: 0.25 x
           0.25 sulcus in a 10 x 1 channel, 20 mu factors, MG-CG in one
           batched solve).  Every column's relative residual is recomputed
           in f64 on the host, 3 columns are checked against scipy's
           sparse direct solve, and the CSV against the committed h = 0.02
           artifact.
  Phase B  the adv-diff step validation (studies.adv_diff) for one Pe row
           with all its mu values: Taylor-Hood MINRES + MG Stokes, then
           MG-BiCGStab with per-sample step-mu Robin matrices.  Rows are
           checked against the committed h = 0.02 artifact and both
           solvers must report convergence.
  --devices N  only __graft_entry__.sharded_checks on N cards (MG-CG and
           step-mu MG-BiCGStab on a (N/2 sweep x 2 cells) mesh, the
           study drivers' default --tp 2; Stokes MINRES over all cards on
           the cells axis; all under shard_map), each against the
           one-card solve.

Each phase prints its wall time with compile time apart.  The last line
of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; a failed phase or
comparison exits non-zero without it.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PHASE_A_CSV = os.path.join(REPO, "examples", "phase_a_h0.02",
                           "Mu Parameter Sweep Analysis",
                           "mu_parameter_sweep_results.csv")
PHASE_B_CSV = os.path.join(REPO, "examples", "advdiff_h0.02",
                           "Results Data",
                           "advdiff_validation_step_pe_x_mu.csv")
MESH_SIZE = 0.02
PHASE_B_PE = 1.0
RESID_TOL = 1e-11      # certified relative residual, f64 on the host
DIRECT_TOL = 1e-9      # max-norm relative error vs scipy spsolve
ARTIFACT_TOL = 1e-6    # relative, vs the committed h = 0.02 CSVs
SHARD_TOL = 1e-7       # relative, sharded vs one-card solve
SHARD_TP = 2           # cells-partition degree of the transport paths


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, duration, **_):
        if name in self.EVENTS:
            self.seconds += duration


def require_gpu(n_devices):
    """Exit non-zero unless JAX's first device is a GPU and at least
    n_devices exist."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}")
    if len(devs) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPUs; JAX found "
                 f"{len(devs)}")


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


def exceeds(x, tol):
    """True unless x <= tol: a NaN fails every check."""
    return not (x <= tol)


def compare_rows(rows, ref_rows, key, cols):
    """Worst relative difference per column of `rows` against the
    reference rows with the same key, with NaN propagated.  A reference
    cell that is empty is not compared.  Returns (worst, failures);
    a row missing on either side is a failure."""
    ref = {key(r): r for r in ref_rows}
    diffs = {c: [] for c in cols}
    fails = []
    for r in rows:
        rr = ref.pop(key(r), None)
        if rr is None:
            fails.append(f"row {key(r)} is not in the reference")
            continue
        for c in cols:
            if rr[c] != "":
                diffs[c].append(_rel(r[c], rr[c]))
    fails += [f"reference row {k} was not produced" for k in ref]
    worst = {c: float(np.max(d)) for c, d in diffs.items() if d}
    fails += [f"{c} relative difference {w:.2e} > {ARTIFACT_TOL:g}"
              for c, w in worst.items() if exceeds(w, ARTIFACT_TOL)]
    return worst, fails


def _host_csr(blk, n):
    """Assembled f64 scipy CSR of one element block."""
    from scipy.sparse import coo_matrix
    dofs = np.asarray(blk.dofs)
    Ae = np.asarray(blk.A64)
    rows = np.broadcast_to(dofs[:, :, None], Ae.shape).ravel()
    cols = np.broadcast_to(dofs[:, None, :], Ae.shape).ravel()
    return coo_matrix((Ae.ravel(), (rows, cols)), shape=(n, n)).tocsr()


def host_check(mesh, D, mus, X, ref_columns):
    """Relative residual of every column of X, recomputed in f64 on the
    host from the assembled matrices, and the max-norm relative error of
    `ref_columns` against scipy's sparse direct solve."""
    from scipy.sparse.linalg import spsolve
    from fenics_eff_uptake.parallel.sweep import build_transport_system
    sys0 = build_transport_system(mesh, element="P2", pad_shapes=False,
                                  band=False)
    n = sys0.ndofs
    K, R = _host_csr(sys0.K, n), _host_csr(sys0.R, n)
    free = np.asarray(sys0.free)
    g = np.where(free, 0.0, np.asarray(sys0.bc_values))
    rel, direct = [], {}
    for i, mu in enumerate(mus):
        A = D * K + mu * R
        x = np.asarray(X[i], dtype=np.float64)
        r = np.concatenate([(A @ x)[free], (g - x)[~free]])
        b = np.concatenate([-(A @ g)[free], g[~free]])
        rel.append(np.linalg.norm(r) / np.linalg.norm(b))
        if i in ref_columns:
            Aff = A[free][:, free]
            x_ref = g.copy()
            x_ref[free] = spsolve(Aff.tocsc(), -(A @ g)[free])
            direct[i] = float(np.abs(x - x_ref).max()
                              / np.abs(x_ref).max())
    return np.asarray(rel), direct


def phase_a(mesh_size, out_dir, artifact=PHASE_A_CSV, clock=None):
    """The Phase-A mu sweep; returns (summary dict, list of failures)."""
    from fenics_eff_uptake.studies.common import (make_no_adv_params,
                                                  no_adv_batch)
    from fenics_eff_uptake.studies.phase_a import (MU_SWEEP_REGIMES,
                                                   run_mu_sweep)
    fails = []
    c0 = clock.seconds if clock else 0.0
    t0 = time.time()
    rows = run_mu_sweep(mesh_size, base_dir=os.path.join(out_dir, "a"),
                        verbose=False)
    t_cold = time.time() - t0
    t_compile = (clock.seconds - c0) if clock else None
    # the same batch again, warm: solutions and solver diagnostics
    factors = [f for fs in MU_SWEEP_REGIMES.values() for f in fs]
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=mesh_size)
    t0 = time.time()
    res = no_adv_batch(geom, factors, "sulcus", verbose=False)
    t_warm = time.time() - t0
    mesh = res[0]["mesh_results"]["mesh"]
    mus = [r["params"].mu for r in res]
    X = [np.asarray(r["c"].values) for r in res]
    iters = [r["solver"]["iters"] for r in res]
    ref_cols = (0, len(mus) // 2, len(mus) - 1)
    rel, direct = host_check(mesh, geom.D, mus, X, ref_cols)
    resid = float(np.max(rel))           # NaN if any column is NaN
    direct_err = float(np.max(list(direct.values())))
    s = {"ndofs": int(X[0].shape[0]), "columns": len(mus),
         "cold_s": t_cold, "compile_s": t_compile, "warm_s": t_warm,
         "iters": iters, "max_rel_resnorm_host_f64": resid,
         "direct_max_rel_err": direct_err}
    if exceeds(resid, RESID_TOL):
        fails.append(f"phase A: host f64 relative residual {resid:.2e}"
                     f" > {RESID_TOL:g}")
    if exceeds(direct_err, DIRECT_TOL):
        fails.append(f"phase A: vs scipy spsolve {direct} > {DIRECT_TOL:g}")
    if artifact is not None:
        worst, f = compare_rows(rows, _read_csv(artifact),
                                lambda r: r["Config"],
                                ("Mu_Eff_Simulation", "Ratio_Sim"))
        s["artifact_max_rel_diff"] = worst
        fails += [f"phase A: vs committed CSV: {m}" for m in f]
    return s, fails


def phase_b(mesh_size, out_dir, artifact=PHASE_B_CSV, pe=PHASE_B_PE,
            clock=None):
    """One Pe row of the adv-diff validation; returns (summary, failures)."""
    from fenics_eff_uptake.studies.adv_diff import (
        MU_FACTORS, run_advdiff_step_validation)
    fails = []
    walls = []
    c0 = clock.seconds if clock else 0.0
    t_compile = None
    ref = None
    if artifact is not None:
        ref = [r for r in _read_csv(artifact) if float(r["Pe"]) == pe]

    def key(r):
        return float(r["Pe"]), float(r["mu_factor"]), r["domain_type"]

    for run in ("cold", "warm"):   # both runs' results are checked
        base = os.path.join(out_dir, f"b_{run}")
        t0 = time.time()
        rows = run_advdiff_step_validation(
            base, mesh_size_dim=mesh_size, pe_values=[pe],
            mu_factors=MU_FACTORS, verbose=False)
        walls.append(time.time() - t0)
        if run == "cold" and clock:
            t_compile = clock.seconds - c0
        with open(os.path.join(base, "Results Data",
                               "study_metadata.json")) as f:
            solvers = json.load(f)["solvers"]
        fails += [f"{m} ({run} run)" for m in solver_failures(solvers)]
        if ref is not None:
            worst, f = compare_rows(rows, ref, key, ("CR", "avg_conc"))
            fails += [f"phase B ({run} run): vs committed CSV: {m}"
                      for m in f]
    s = {"rows": len(rows), "cold_s": walls[0], "compile_s": t_compile,
         "warm_s": walls[1], "solvers": solvers}
    if ref is not None:
        s["artifact_max_rel_diff"] = worst
    return s, fails


def solver_failures(solvers):
    """Phase B's solver checks on the study metadata's per-domain
    records: Stokes converged and a BiCGStab residual within RESID_TOL
    (NaN fails)."""
    fails = []
    for dom, rec in solvers.items():
        if rec["stokes"].get("converged") is not True:
            fails.append(f"phase B: {dom} Stokes MINRES did not converge")
        r = rec["transport_max_rel_resnorm"]
        if exceeds(r, RESID_TOL):
            fails.append(f"phase B: {dom} BiCGStab relative residual "
                         f"{r:.2e} > {RESID_TOL:g}")
    if not solvers:
        fails.append("phase B: no solver records")
    return fails


def phase_sharded(n_devices, mesh_size):
    """__graft_entry__.sharded_checks on the first n_devices cards."""
    from __graft_entry__ import sharded_checks
    # the transport paths on the study drivers' default --tp 2 mesh
    # (sweep x cells = 2 x 2 on four cards: psum over "cells" every
    # Krylov step); Stokes has no sweep batch and takes all cards
    out = sharded_checks(n_devices, mesh_size=mesh_size, tp=SHARD_TP,
                         tp_stokes=n_devices, rtol=1e-11)
    fails = [f"sharded {r['path']}: vs-single {r['err']:.2e}"
             for r in out if exceeds(r["err"], SHARD_TOL)]
    return {"paths": out}, fails


def _report(name, summary, t_wall):
    print(f"== {name}: {t_wall:.1f} s wall")
    print(json.dumps(summary, default=str))
    sys.stdout.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1 (default): Phases A and B on one card; N > 1: "
                         "only the sharded paths on N cards")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "chip_smoke"),
                    help="directory for the studies' CSVs")
    args = ap.parse_args(argv)

    from fenics_eff_uptake.utils.device import (device_info,
                                                nvidia_smi_name_power)
    smi = nvidia_smi_name_power()
    if smi:
        print(smi)
    require_gpu(args.devices)
    # a self-contained run: no solved fields or setup plans from disk
    os.environ["FEU_DISK_CACHE"] = "0"
    from fenics_eff_uptake.utils.jaxconfig import compile_cache_dir, setup
    jax = setup(x64=True)
    from fenics_eff_uptake.meshing import native
    dev = device_info()
    print(f"device: {dev}; jax {jax.__version__}; compile cache "
          f"{compile_cache_dir()}")
    fails = []
    if native.available():
        print("mesher: native C++ kernel (native/meshkernel.cpp)")
    else:
        fails.append("mesher: the native kernel could not be built or "
                     "loaded; the scipy fallback ran")
        print(fails[-1])
    clock = CompileClock()
    if args.devices > 1:
        phases = [("sharded", lambda: phase_sharded(args.devices,
                                                    MESH_SIZE))]
    else:
        phases = [("phase A", lambda: phase_a(MESH_SIZE, args.out,
                                              clock=clock)),
                  ("phase B", lambda: phase_b(MESH_SIZE, args.out,
                                              clock=clock))]
    for name, fn in phases:
        t0 = time.time()
        try:
            summary, f = fn()
        except Exception:
            traceback.print_exc()
            f, summary = [f"{name}: raised (traceback above)"], {}
        _report(name, summary, time.time() - t0)
        fails += f
    stats = jax.devices()[0].memory_stats() or {}
    print(f"device 0 peak bytes in use: {stats.get('peak_bytes_in_use')}")
    if fails:
        print("FAILED:\n  " + "\n  ".join(fails), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
