"""No-uptake flow study: geometry x Peclet sweep + rectangular baselines.

JAX re-implementation of ``no_uptake_analysis.py``: 23 geometries x
Pe in {0.1, 1, 10} sulcus runs (mu = 0, real Stokes flow) plus 3
rectangular baselines, combined CSV with ratio columns joined against the
rect baselines per Pe (ref :262-313), and per-geometry profile sample CSVs
(ref :315-434).  CSV schema matches geometry_comparison_results.csv.

Restructuring: per mesh ONE Stokes solve feeds all Pe (the
nondimensional velocity is Pe-independent) and the Pe transport solves are
ONE vmapped batched BiCGStab (D* = 1/Pe is the batch coefficient).

Note on velocity columns: the reference reads 'max_ux_sulcus_level' which
its own compute_velocity_metrics no longer emits (SURVEY.md 5.9 latent
defect); here the sulcus-level line IS produced (the y ~ 0 mouth-level
line), so fresh runs populate those columns.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from ..analysis.profiles import compute_conc_profiles, compute_velocity_metrics
from ..fem.space import Function
from ..params import Parameters, create_geometry_variations
from ..simulation import get_mesh
from .common import (create_study_dirs, save_csv, save_metadata,
                     sharded_stokes_or_single, transport_batch)

__all__ = ["run_geometry_study", "run_rectangular_baselines",
           "add_ratio_metrics", "export_profile_samples_csv_sulci",
           "export_profile_stats_csv",
           "replot_from_csv", "PECLET_NUMBERS", "PROFILE_GEOMETRIES"]

PECLET_NUMBERS = [0.1, 1.0, 10.0]
PROFILE_GEOMETRIES = ["largest", "square_small"]
BASE_DIR = "Results/No Uptake Simulations"


def _make_params(pe, w=None, h=None, mesh_size_dim=None) -> Parameters:
    """no-uptake Parameters with U_ref_dim = Pe*D/H (ref :119-127)."""
    p = Parameters(mode="no-uptake")
    p.mu_dim = 0.0
    if w is not None:
        p.sulci_w_dim = w
    if h is not None:
        p.sulci_h_dim = h
    if mesh_size_dim is not None:
        p.mesh_size_dim = mesh_size_dim
    p.U_ref_dim = pe * p.D_dim / p.H_dim
    p.validate()
    p.nondim()
    return p


def _vm_aliases(vm):
    """Sulcus-level aliases for the reference CSV columns."""
    return {
        "max_ux_sulcus_level": vm.get("max_ux_mouth_level"),
        "avg_ux_sulcus_level": vm.get("avg_ux_mouth_level"),
    }


def _sulcus_row(params, mm, fm, vm):
    """Row for a sulcus run (ref extract_simulation_data :146-239)."""
    w, h = params.sulci_w_dim, params.sulci_h_dim
    D_dim = params.U_ref_dim * params.H_dim / params.Pe
    pf = fm.get("physical_flux", {})
    mouth = (fm.get("sulcus_specific", {}).get("physical_flux", {})
             .get("sulcus_opening", {}))
    extra = (fm.get("sulcus_specific", {}).get("physical_flux", {})
             .get("sulcus_opening_extra", {}))
    avg = mm["average_concentration"]
    al = _vm_aliases(vm)
    return {
        "Domain": "sulcus", "Mode": params.mode, "Peclet": params.Pe,
        "U_ref": params.U_ref,
        "Sulcus Width (mm)": w, "Sulcus Depth (mm)": h,
        "Aspect_Ratio": h / w if w and w > 0 else None,
        "U_ref (Dim)": params.U_ref_dim, "Diff Coef (Dim)": D_dim,
        "Delta (mm)": D_dim / params.U_ref_dim,
        "Total Mass": mm.get("total_mass"),
        "Sulcus Mass": mm.get("sulcus_mass"),
        "Main Channel Mass": mm.get("rectangle_mass"),
        "Avg Concentration": avg.get("total"),
        "Sulcus Avg Concentration": avg.get("sulcus_region"),
        "Main Channel Avg Concentration": avg.get("rectangle_region"),
        "Mouth_Flux_Total": mouth.get("total"),
        "Inlet-Outlet Flux": (pf.get("left", {}).get("total", 0)
                              + pf.get("right", {}).get("total", 0)),
        "Mouth E_L1": extra.get("E_L1"),
        "Mouth E_avg": extra.get("E_avg"),
        "Mouth Q_in": extra.get("Q_in"),
        "Mouth Q_out": extra.get("Q_out"),
        "Mouth Net Check": extra.get("net_check"),
        "Mouth Length": extra.get("length"),
        "Max_Ux_mid_channel": vm.get("max_ux_mid_channel"),
        "Avg_Ux_mid_channel": vm.get("avg_ux_mid_channel"),
        "Max_Ux_sulcus_level": al["max_ux_sulcus_level"],
        "Avg_Ux_sulcus_level": al["avg_ux_sulcus_level"],
    }


def run_rectangular_baselines(peclet_numbers=None, mesh_size_dim=None,
                              precision=None, verbose=True,
                              collect_profiles=False):
    """Rect baselines per Pe (ref :109-140); one Stokes + batched transport.

    collect_profiles=True also samples the rectangle's line profiles so
    the profile-grid figures can overlay them WITHOUT re-simulating at
    plot time (the reference re-runs rect sims lazily, ref :709-745);
    returns (rows, profile_rows_per_pe) in that case."""
    peclet_numbers = list(peclet_numbers or PECLET_NUMBERS)
    p0 = _make_params(peclet_numbers[0], mesh_size_dim=mesh_size_dim)
    mesh = get_mesh(p0, "rectangular")
    u, p = sharded_stokes_or_single(mesh, H=p0.H)
    D_batch = [1.0 / pe for pe in peclet_numbers]
    X, info, sys = transport_batch(mesh, u, D_batch,
                                   mu_batch=[0.0] * len(D_batch),
                                   precision=precision)
    from ..analysis.batched_metrics import (build_sweep_metrics,
                                            metrics_to_dicts)
    import jax.numpy as jnp
    params_list = [_make_params(pe, mesh_size_dim=mesh_size_dim)
                   for pe in peclet_numbers]
    sm = build_sweep_metrics(sys.space, mesh, D=1.0, u=u)
    flux_list, mass_list, _ = metrics_to_dicts(
        sm, mesh, jnp.asarray(X), [0.0] * len(peclet_numbers), 1.0,
        params_list, D_values=D_batch)
    vm_shared = compute_velocity_metrics(u, mesh, params_list[0])
    rows = []
    for i, pe in enumerate(peclet_numbers):
        params = params_list[i]
        fm = flux_list[i]
        mm = mass_list[i]
        vm = vm_shared
        pf = fm.get("physical_flux", {})
        D_dim = params.U_ref_dim * params.H_dim / params.Pe
        rows.append({
            "Domain": "rectangle", "Mode": params.mode,
            "Peclet": params.Pe, "U_ref": params.U_ref,
            "Sulcus Width (mm)": None, "Sulcus Depth (mm)": None,
            "Aspect_Ratio": None,
            "U_ref (Dim)": params.U_ref_dim, "Diff Coef (Dim)": D_dim,
            "Delta (mm)": D_dim / params.U_ref_dim,
            "Total Mass": mm.get("total_mass"),
            "Sulcus Mass": None,
            "Main Channel Mass": mm.get("total_mass"),
            "Avg Concentration": mm.get("average_concentration"),
            "Sulcus Avg Concentration": None,
            "Main Channel Avg Concentration": mm.get(
                "average_concentration"),
            "Mouth_Flux_Total": None,
            "Inlet-Outlet Flux": (pf.get("left", {}).get("total", 0)
                                  + pf.get("right", {}).get("total", 0)),
            "Mouth E_L1": None, "Mouth E_avg": None, "Mouth Q_in": None,
            "Mouth Q_out": None, "Mouth Net Check": None,
            "Mouth Length": None,
            "Max_Ux_mid_channel": vm.get("max_ux_mid_channel"),
            "Avg_Ux_mid_channel": vm.get("avg_ux_mid_channel"),
            "Max_Ux_sulcus_level": None, "Avg_Ux_sulcus_level": None,
        })
        if verbose:
            print(f"  rect baseline Pe={pe}: avg_conc="
                  f"{rows[-1]['Avg Concentration']:.6f}")
    if collect_profiles:
        prof_rows = []
        for i, pe in enumerate(peclet_numbers):
            c = Function(sys.space, X[i])
            prof_rows.extend(collect_profile_rows(
                c, mesh, params_list[i], "rectangle", "rectangle",
                domain_type="rectangular"))
        return rows, prof_rows
    return rows


RATIO_COLUMNS = ["Concentration_Ratio", "Channel_Conc_Ratio",
                 "Intradomain_Enrichment", "VR_mid_avg", "VR_mid_max",
                 "VR_intradomain_avg", "VR_intradomain_max"]


def _num(v):
    return np.nan if v is None else float(v)


def _div(a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(_num(a)) / np.float64(_num(b)))


def add_ratio_metrics(rows):
    """Join ratio columns against rect baselines per Pe (ref :262-313):
    each sulcus row is divided by the mean of the rectangle rows at its
    Peclet number; every other cell of a ratio column is NaN."""
    rect = {}
    for r in rows:
        if r["Domain"] == "rectangle":
            rect.setdefault(r["Peclet"], []).append(r)

    def mean(rs, col):
        vals = [_num(r[col]) for r in rs]
        vals = [v for v in vals if not np.isnan(v)]
        return float(np.mean(vals)) if vals else np.nan

    for r in rows:
        for col in RATIO_COLUMNS:
            r[col] = np.nan
        if r["Domain"] != "sulcus" or r["Peclet"] not in rect:
            continue
        rs = rect[r["Peclet"]]
        r_conc = mean(rs, "Avg Concentration")
        r_max = mean(rs, "Max_Ux_mid_channel")
        r_avg = mean(rs, "Avg_Ux_mid_channel")
        r["Concentration_Ratio"] = _div(r["Avg Concentration"], r_conc)
        r["Channel_Conc_Ratio"] = _div(
            r["Main Channel Avg Concentration"], r_conc)
        r["VR_mid_avg"] = _div(r["Avg_Ux_mid_channel"], r_avg)
        r["VR_mid_max"] = _div(r["Max_Ux_mid_channel"], r_max)
        r["Intradomain_Enrichment"] = _div(
            r["Sulcus Avg Concentration"],
            r["Main Channel Avg Concentration"])
        r["VR_intradomain_avg"] = _div(r["Avg_Ux_sulcus_level"],
                                       r["Avg_Ux_mid_channel"])
        r["VR_intradomain_max"] = _div(r["Max_Ux_sulcus_level"],
                                       r["Max_Ux_mid_channel"])
    return rows


def collect_profile_rows(c, mesh, params, geometry_key, config_name,
                         domain_type="sulcus"):
    """Tidy per-sample-point profile rows (ref :315-360)."""
    prof = compute_conc_profiles(c, mesh, params, domain_type)
    meta = prof["profiles_meta"]
    x_rng, y_rng = meta.get("x_range"), meta.get("y_range")
    rows = []
    for ltype, coord_key in (("horizontal", "x"), ("vertical", "y")):
        for name, payload in prof["profiles_full"][ltype].items():
            fixed = payload["y" if ltype == "horizontal" else "x"]
            coords = payload[coord_key]
            cs = payload["c"]
            for i, (cc, vv) in enumerate(zip(coords, cs)):
                rows.append({
                    "Domain": domain_type,
                    "Geometry": geometry_key,
                    "Config": config_name,
                    "Peclet": params.Pe,
                    "LineType": ltype,
                    "LineName": name,
                    "Index": i,
                    "x": cc if ltype == "horizontal" else fixed,
                    "y": fixed if ltype == "horizontal" else cc,
                    "c": vv,
                    "n_points": meta.get("n_points"),
                    "x_min": None if x_rng is None else x_rng[0],
                    "x_max": None if x_rng is None else x_rng[1],
                    "y_min": None if y_rng is None else y_rng[0],
                    "y_max": None if y_rng is None else y_rng[1],
                })
    return rows


def export_profile_stats_csv(profile_runs, out_dir):
    """Per-line profile statistics CSVs (ref :394-434): one
    profiles_<geometry>.csv with min/max/avg per line per Pe, lines in
    sorted (line type, name, Pe) order."""
    os.makedirs(out_dir, exist_ok=True)
    by_geom: Dict[str, list] = {}
    for run in profile_runs:
        groups: Dict[tuple, list] = {}
        for r in run["rows"]:
            groups.setdefault((r["LineType"], r["LineName"], r["Peclet"]),
                              []).append(r)
        for (ltype, name, pe) in sorted(groups):
            sub = groups[(ltype, name, pe)]
            c = np.array([r["c"] for r in sub], dtype=float)
            by_geom.setdefault(run["geometry"], []).append({
                "Geometry": run["geometry"], "Peclet": pe,
                "line_type": ltype, "name": name,
                "x": None if ltype == "horizontal"
                else float(sub[0]["x"]),
                "y": float(sub[0]["y"])
                if ltype == "horizontal" else None,
                "min_c": float(np.nanmin(c)),
                "max_c": float(np.nanmax(c)),
                "avg_c": float(np.nanmean(c)),
                "n_samples": len(sub),
            })
    for gkey, rows in by_geom.items():
        path = os.path.join(out_dir, f"profiles_{gkey}.csv")
        save_csv(rows, path)


def export_profile_samples_csv_sulci(profile_runs, out_dir):
    """One CSV per geometry: profiles_samples_<geometry>.csv (ref :361-393)."""
    os.makedirs(out_dir, exist_ok=True)
    by_geom: Dict[str, list] = {}
    for run in profile_runs:
        by_geom.setdefault(run["geometry"], []).extend(run["rows"])
    for gkey, rows in by_geom.items():
        path = os.path.join(out_dir, f"profiles_samples_{gkey}.csv")
        save_csv(rows, path)


def run_geometry_study(peclet_numbers=None, mesh_size_dim=None,
                       geometries=None, base_dir=BASE_DIR,
                       precision=None, verbose=True):
    """The full no-uptake study (ref :921-1035); returns the CSV rows."""
    peclet_numbers = list(peclet_numbers or PECLET_NUMBERS)
    print("=" * 64 + "\nNO-UPTAKE GEOMETRY x PECLET STUDY\n" + "=" * 64)
    t0 = time.time()
    study_dir, _ = create_study_dirs("Geometry Comparison", base_dir)

    base = Parameters(mode="no-uptake")
    configs = create_geometry_variations(base, max_width=1.0)
    if geometries is not None:
        configs = {k: v for k, v in configs.items() if k in geometries}

    rows = []
    profile_runs = []
    for gkey, gcfg in configs.items():
        try:
            w, h = gcfg["sulci_w_dim"], gcfg["sulci_h_dim"]
            p0 = _make_params(peclet_numbers[0], w, h, mesh_size_dim)
            mesh = get_mesh(p0, "sulcus")
            t1 = time.time()
            u, p = sharded_stokes_or_single(mesh, H=p0.H)
            t_stokes = time.time()
            D_batch = [1.0 / pe for pe in peclet_numbers]
            t_setup = time.time()
            X, info, sys = transport_batch(
                mesh, u, D_batch, mu_batch=[0.0] * len(D_batch),
                precision=precision)
            t_solve = time.time()
            # ONE batched metrics dispatch for all Pe columns
            # (analysis/batched_metrics.py; equivalence-tested vs the
            # per-run engine -- see tests/test_analysis.py)
            from ..analysis.batched_metrics import (build_sweep_metrics,
                                                    metrics_to_dicts)
            import jax.numpy as jnp
            params_list = [_make_params(pe, w, h, mesh_size_dim)
                           for pe in peclet_numbers]
            sm = build_sweep_metrics(sys.space, mesh, D=1.0, u=u)
            flux_list, mass_list, _ = metrics_to_dicts(
                sm, mesh, jnp.asarray(X), [0.0] * len(peclet_numbers),
                1.0, params_list, D_values=D_batch)
            vm = compute_velocity_metrics(u, mesh, params_list[0])
            for i, pe in enumerate(peclet_numbers):
                rows.append(_sulcus_row(params_list[i], mass_list[i],
                                        flux_list[i], vm))
                if gkey in PROFILE_GEOMETRIES:
                    c = Function(sys.space, X[i])
                    profile_runs.append({
                        "geometry": gkey,
                        "rows": collect_profile_rows(
                            c, mesh, params_list[i], gkey, gkey)})
            if verbose:
                print(f"  {gkey}: {len(peclet_numbers)} Pe points in "
                      f"{time.time()-t1:.1f}s")
            if verbose and os.environ.get("FEU_STUDY_TIMERS"):
                print(f"    [timers] stokes={t_stokes - t1:.2f}s "
                      f"setup+solve={t_solve - t_setup:.2f}s "
                      f"(iters={np.asarray(info['iters']).tolist()}) "
                      f"metrics+rows={time.time() - t_solve:.2f}s")
        except Exception as e:
            print(f"  {gkey} failed: {e}")

    if profile_runs:
        rect_rows, rect_prof = run_rectangular_baselines(
            peclet_numbers, mesh_size_dim, precision, verbose,
            collect_profiles=True)
        # merge the rectangle overlay curves into every profile
        # geometry's sample set (Domain column distinguishes them)
        for gkey in {r["geometry"] for r in profile_runs}:
            profile_runs.append({"geometry": gkey, "rows": rect_prof})
    else:
        rect_rows = run_rectangular_baselines(peclet_numbers,
                                              mesh_size_dim, precision,
                                              verbose)
    rows.extend(rect_rows)
    rows = add_ratio_metrics(rows)
    csv_path = os.path.join(study_dir, "geometry_comparison_results.csv")
    save_csv(rows, csv_path)

    if profile_runs:
        prof_dir = os.path.join(study_dir, "Profiles")
        export_profile_samples_csv_sulci(profile_runs, prof_dir)
        export_profile_stats_csv(profile_runs, prof_dir)
        try:
            from ..plotting.no_uptake_plots import (
                plot_profiles_grid_from_samples_csv)
            from glob import glob
            for csv in glob(os.path.join(prof_dir,
                                         "profiles_samples_*.csv")):
                plot_profiles_grid_from_samples_csv(csv)
        except Exception as e:
            print(f"  profile grid plotting failed: {e}")

    try:
        import pandas as pd
        from ..plotting.no_uptake_plots import generate_all_plots
        generate_all_plots(pd.read_csv(csv_path),
                           os.path.join(study_dir, "Plots"))
    except Exception as e:
        print(f"  heatmap plotting failed: {e}")

    save_metadata({
        "study_type": "No-Uptake Geometry Comparison",
        "peclet_numbers": peclet_numbers,
        "n_geometries": len(configs),
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"No-uptake study done in {time.time() - t0:.1f}s")
    return rows


def replot_from_csv(base_dir=BASE_DIR):
    import pandas as pd
    study_dir = os.path.join(base_dir, "Geometry Comparison Analysis")
    csv_path = os.path.join(study_dir, "geometry_comparison_results.csv")
    if not os.path.exists(csv_path):
        print(f"No CSV at {csv_path}")
        return None
    df = pd.read_csv(csv_path)
    try:
        from ..plotting.no_uptake_plots import generate_all_plots
        generate_all_plots(df, os.path.join(study_dir, "Plots"))
    except ImportError:
        pass
    return df


def main(argv=None):
    # bare-module entry: same f64 + persistent-compile-cache
    # config as the package menu (committed study artifacts
    # are x64; a silent f32 run would look converged but
    # carry ~1e-5 floors)
    from ..utils.jaxconfig import setup
    setup(x64=True)
    import argparse
    ap = argparse.ArgumentParser(description="No-uptake geometry x Pe study")
    ap.add_argument("command", choices=["run", "baselines", "replot"],
                    nargs="?", default="run")
    ap.add_argument("--mesh-size", type=float, default=None)
    ap.add_argument("--output-base", default=None)
    ap.add_argument("--geometries", default=None,
                    help="comma-separated geometry keys (default: all)")
    ap.add_argument("--shard", type=int, default=0, metavar="N",
                    help="run ALL solves (Stokes saddle + Pe transport "
                         "batches) sharded over an N-device mesh "
                         "(parallel/sharded_solve.py)")
    ap.add_argument("--tp", type=int, default=2,
                    help="cells-partition degree of the device mesh")
    args = ap.parse_args(argv)
    if args.shard:
        from .common import use_shard_devices
        use_shard_devices(args.shard, args.tp)
    if args.command == "run":
        geoms = (args.geometries.split(",") if args.geometries else None)
        run_geometry_study(mesh_size_dim=args.mesh_size,
                           geometries=geoms,
                           base_dir=args.output_base or BASE_DIR)
    elif args.command == "baselines":
        run_rectangular_baselines(mesh_size_dim=args.mesh_size)
    else:
        replot_from_csv()


if __name__ == "__main__":
    main()
