"""JAX finite-element framework for the sulcus effective-uptake study.

A from-scratch JAX/XLA re-design of the capability surface of
``jesstunn/fenics-eff-uptake`` (FEniCS 2019.1 study of steady solute transport
in a 2-D channel with a sinusoidal cavity): own unstructured triangle mesher,
P1/P2/Taylor-Hood elements, batched element assembly, matrix-free Krylov
solvers on the accelerator, Robin uptake boundary conditions mu(x) (uniform and
smoothed-step), boundary-flux / mass / mu_eff post-processing, and vmapped
parameter sweeps.

Layer map (mirrors SURVEY.md section 1):
  params    -- Parameters / nondimensionalisation   (ref: parameters.py)
  meshing   -- own mesher + markers                  (ref: mesh.py + Gmsh)
  fem       -- quadrature, elements, dofmaps, assembly (ref: dolfin/FFC)
  ops       -- JAX compute kernels (SpMV, scatter)    (ref: PETSc)
  solvers   -- matrix-free CG/GMRES/Stokes            (ref: dolfin LU)
  models    -- diffusion / advdiff / stokes problems  (ref: solvers.py)
  analysis  -- flux, mass, profiles, mu_eff           (ref: analysis.py)
  parallel  -- sweep batching + device-mesh sharding  (new; ref is serial)
  studies   -- batch study drivers                    (ref: *_analysis*.py)
"""

__version__ = "0.1.0"
