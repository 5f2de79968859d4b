"""Measured MINRES iteration counts for the MG Stokes solver (CPU f64).

Usage: python scripts/diag_stokes_iters.py [mesh_size] [depth] [width_s]
Compares FEU_STOKES_COARSE_P=0 vs 1 on the same geometry.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MESH_SIZE = float(sys.argv[1]) if len(sys.argv) > 1 else 0.1
DEPTH = float(sys.argv[2]) if len(sys.argv) > 2 else 0.25
WIDTH_S = float(sys.argv[3]) if len(sys.argv) > 3 else 0.25


def main():
    from fenics_eff_uptake.utils.jaxconfig import setup
    jax = setup(x64=True)
    jax.config.update("jax_platforms", "cpu")

    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.models import stokes_flow

    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=DEPTH,
                         sulcus_width=WIDTH_S, mesh_size=MESH_SIZE,
                         refinement_factor=1, domain_type="sulcus")
    print(f"cells={mesh.num_cells}", flush=True)

    for flag in ("0", "1"):
        os.environ["FEU_STOKES_COARSE_P"] = flag
        t0 = time.time()
        u, p = stokes_flow.stokes_solve_mg(mesh, H=1.0, precision="f64")
        info = u.solver_info
        print(f"coarse_p={flag}: iters={info['outer_iters']} "
              f"resnorm={info['resnorm']:.2e} "
              f"converged={info['converged']} "
              f"wall={time.time()-t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
