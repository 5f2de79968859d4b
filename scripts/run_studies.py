"""Run the full-size (h=0.02) studies on the accelerator, one at a time.

Usage:  python scripts/run_studies.py <study> [--out-base BASE]
        study in {phase_a_mu, phase_a_spatial, phase_a_geometry,
                  phase_a_ar, phase_b, adv_diff, no_uptake, all}

Artifacts land under examples/<study>_h0.02/ for commit, with the
same CSV schemas as the reference's shipped results (PARITY.md compares
row by row).
"""
import argparse
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("study")
    ap.add_argument("--mesh-size", type=float, default=0.02)
    ap.add_argument("--out-base", default="examples",
                    help="artifact base dir (default examples/; point at "
                         "a scratch dir for timing re-measurements so the "
                         "committed artifacts stay untouched)")
    args = ap.parse_args()

    from fenics_eff_uptake.utils.jaxconfig import setup
    setup(x64=True)

    h = args.mesh_size
    tag = f"h{h:g}"
    todo = ([args.study] if args.study != "all" else
            ["adv_diff", "phase_a_mu", "phase_a_spatial",
             "phase_a_geometry", "phase_a_ar", "phase_b", "no_uptake"])

    for study in todo:
        t0 = time.time()
        print(f"\n===== {study} (h={h}) =====", flush=True)
        try:
            if study == "phase_a_mu":
                from fenics_eff_uptake.studies.phase_a import \
                    run_mu_sweep
                run_mu_sweep(mesh_size_dim=h,
                             base_dir=f"{args.out_base}/phase_a_{tag}")
            elif study == "phase_a_spatial":
                from fenics_eff_uptake.studies.phase_a import \
                    run_mu_eff_analysis
                run_mu_eff_analysis(mesh_size_dim=h,
                                    base_dir=f"{args.out_base}/phase_a_{tag}")
            elif study == "phase_a_geometry":
                from fenics_eff_uptake.studies.phase_a import \
                    run_geometry_analysis
                run_geometry_analysis(mesh_size_dim=h,
                                      base_dir=f"{args.out_base}/phase_a_{tag}")
            elif study == "phase_a_ar":
                from fenics_eff_uptake.studies.phase_a import \
                    run_aspect_ratio_analysis
                run_aspect_ratio_analysis(
                    mesh_size_dim=h, base_dir=f"{args.out_base}/phase_a_{tag}")
            elif study == "phase_b":
                from fenics_eff_uptake.studies.phase_b import \
                    run_no_adv_mu_sweep
                run_no_adv_mu_sweep(
                    output_base=f"{args.out_base}/phase_b_{tag}",
                    mesh_size_dim=h)
            elif study == "adv_diff":
                from fenics_eff_uptake.studies.adv_diff import \
                    run_advdiff_step_validation
                run_advdiff_step_validation(
                    output_base_dir=f"{args.out_base}/advdiff_{tag}",
                    mesh_size_dim=h)
            elif study == "richardson":
                from fenics_eff_uptake.studies.mesh_convergence \
                    import run_mesh_convergence
                run_mesh_convergence(
                    base_dir=f"{args.out_base}/mesh_convergence_{tag}",
                    realisation_check=True)
            elif study == "no_uptake":
                from fenics_eff_uptake.studies.no_uptake import \
                    run_geometry_study
                run_geometry_study(
                    mesh_size_dim=h,
                    base_dir=f"{args.out_base}/no_uptake_{tag}")
            else:
                print(f"unknown study {study}")
                sys.exit(2)
            print(f"===== {study} DONE in {time.time()-t0:.0f}s =====",
                  flush=True)
        except Exception as e:
            import traceback
            traceback.print_exc()
            print(f"===== {study} FAILED after {time.time()-t0:.0f}s: "
                  f"{e} =====", flush=True)


if __name__ == "__main__":
    main()
