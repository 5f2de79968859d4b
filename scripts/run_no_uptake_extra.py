"""Incrementally extend the committed no-uptake artifact, one geometry
per solve batch, so a wall-clock cutoff loses at most one geometry.

Usage: python scripts/run_no_uptake_extra.py g1 [g2 ...]
Each geometry runs the full 3-Pe pipeline into /tmp/nu_extra/<g>/;
scripts/merge_no_uptake.py folds completed runs into the committed CSV.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    from fenics_eff_uptake.utils.jaxconfig import setup
    setup(x64=True)
    from fenics_eff_uptake.studies.no_uptake import run_geometry_study
    for g in sys.argv[1:]:
        t0 = time.time()
        try:
            run_geometry_study(mesh_size_dim=0.02, geometries=[g],
                               base_dir=f"/tmp/nu_extra/{g}")
            print(f"EXTRA {g} DONE in {time.time()-t0:.0f}s", flush=True)
        except Exception as e:
            import traceback
            traceback.print_exc()
            print(f"EXTRA {g} FAILED: {e}", flush=True)


if __name__ == "__main__":
    main()
