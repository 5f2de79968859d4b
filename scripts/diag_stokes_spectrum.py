"""Dense spectral diagnosis of the MINRES+MG Stokes solver.

Builds the preconditioned saddle operator M^(1/2) S M^(1/2) explicitly
(column by column through the production S_fn / M programs) at a small
mesh size and reports its full spectrum.  MINRES convergence on the
block-preconditioned saddle is governed by the two intervals
[-a,-b] u [c,d] the eigenvalues occupy (Silvester & Wathen); this tells
us WHERE the 420-iteration behaviour comes from:

  * negative cluster tail -> 0 : inf-sup / Schur-side problem
    (pressure-mass preconditioning of an elongated channel)
  * positive cluster spread    : velocity MG quality on the pure
    vector Laplacian

Run on CPU f64:  python scripts/diag_stokes_spectrum.py [mesh_size] [width]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MESH_SIZE = float(sys.argv[1]) if len(sys.argv) > 1 else 0.2
WIDTH = float(sys.argv[2]) if len(sys.argv) > 2 else 10.0


def main():
    from fenics_eff_uptake.utils.jaxconfig import setup
    jax = setup(x64=True)
    # a dense spectral diagnosis: run it on the CPU
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from fenics_eff_uptake.meshing.generator import generate_mesh
    from fenics_eff_uptake.models.stokes_flow import _stokes_mg_setup

    mesh = generate_mesh(width=WIDTH, height=1.0, sulcus_depth=0.25,
                         sulcus_width=0.25, mesh_size=MESH_SIZE,
                         refinement_factor=1, domain_type="sulcus")
    st = _stokes_mg_setup(mesh, H=1.0, pad_shapes=False)
    ns, npp = st.ns_pad, st.np_pad
    n_tot = 2 * ns + npp
    print(f"cells={mesh.num_cells} ns_pad={ns} np_pad={npp} "
          f"n_tot={n_tot}", flush=True)
    if n_tot > 9000:
        print("too large for dense analysis; use a coarser mesh")
        return

    S_fn, s64 = st.S_fn, st.s64
    Mfn, Margs = st.M64

    def unpack(v):
        U = v[: 2 * ns].reshape(ns, 2)
        p = v[2 * ns:]
        return (U, p)

    def pack(x):
        U, p = x
        return jnp.concatenate([U.reshape(-1), p])

    Sv = jax.jit(lambda v: pack(S_fn(s64, unpack(v))))
    Mv = jax.jit(lambda v: pack(Mfn(Margs, unpack(v))))

    # build dense S and M by applying to identity columns, vmapped in
    # blocks to keep it fast
    eye = np.eye(n_tot)
    t0 = time.time()
    cols_S = []
    cols_M = []
    bs = 256
    SvB = jax.jit(jax.vmap(Sv, in_axes=1, out_axes=1))
    MvB = jax.jit(jax.vmap(Mv, in_axes=1, out_axes=1))
    for i in range(0, n_tot, bs):
        blk = jnp.asarray(eye[:, i:i + bs])
        cols_S.append(np.asarray(SvB(blk)))
        cols_M.append(np.asarray(MvB(blk)))
    S = np.concatenate(cols_S, axis=1)
    M = np.concatenate(cols_M, axis=1)
    print(f"dense build: {time.time()-t0:.1f}s", flush=True)
    print(f"||S - S^T||_max = {np.abs(S - S.T).max():.2e}")
    print(f"||M - M^T||_max = {np.abs(M - M.T).max():.2e}")

    # symmetrise tiny asymmetries and form M^(1/2) S M^(1/2)
    S = 0.5 * (S + S.T)
    M = 0.5 * (M + M.T)
    w_M = np.linalg.eigvalsh(M)
    print(f"M eig range: [{w_M.min():.3e}, {w_M.max():.3e}]")
    if w_M.min() <= 0:
        print("M NOT SPD -- MINRES theory void; that is the bug")
    wM, VM = np.linalg.eigh(M)
    wM = np.clip(wM, 1e-300, None)
    Mh = (VM * np.sqrt(wM)) @ VM.T
    T = Mh @ S @ Mh
    T = 0.5 * (T + T.T)
    w = np.linalg.eigvalsh(T)

    neg = w[w < -1e-12]
    pos = w[w > 1e-12]
    print(f"n_neg={len(neg)} n_pos={len(pos)} "
          f"n_zero={(np.abs(w) <= 1e-12).sum()}")
    print(f"negative interval: [{neg.min():.4e}, {neg.max():.4e}]")
    print(f"positive interval: [{pos.min():.4e}, {pos.max():.4e}]")
    # MINRES convergence factor for [-a,-b] u [c,d]:
    a, bneg = -neg.min(), -neg.max()
    c, d = pos.min(), pos.max()
    # per Greenbaum: rho = ((sqrt(ad)-sqrt(bc))/(sqrt(ad)+sqrt(bc)))^(1/2 per 2 its)
    import math
    rho = (math.sqrt(a * d) - math.sqrt(bneg * c)) / (
        math.sqrt(a * d) + math.sqrt(bneg * c))
    its = math.log(1e-11) / math.log(rho) * 2 if rho < 1 else float("inf")
    print(f"two-interval bound: a={a:.3e} b={bneg:.3e} c={c:.3e} "
          f"d={d:.3e} rho^(1/2it)={rho:.4f} -> ~{its:.0f} MINRES iters "
          f"for 1e-11")
    # where is the weakness?
    print(f"  neg cond (a/b) = {a/bneg:.2f}  (Schur/inf-sup side)")
    print(f"  pos cond (d/c) = {d/c:.2f}  (velocity MG side)")

    # percentiles of each cluster to see tails vs bulk
    for name, cl in (("neg", -neg[::-1]), ("pos", pos)):
        q = np.percentile(cl, [0, 1, 5, 50, 95, 99, 100])
        print(f"  {name} percentiles (abs): " +
              " ".join(f"{v:.3e}" for v in q))

    # structure of the small-|lambda| negative modes: their pressure
    # component vs low-degree polynomials in x (channel-axis modes?)
    w_all, V_all = np.linalg.eigh(T)
    neg_idx = np.flatnonzero(w_all < -1e-12)
    order = neg_idx[np.argsort(-w_all[neg_idx])]  # smallest |l| first
    pc = np.asarray(st.Q.dof_coords)[: st.np_true]
    xn = (pc[:, 0] - pc[:, 0].min()) / max(np.ptp(pc[:, 0]), 1e-30)
    # Legendre-ish basis on [0,1] in x
    basis = np.stack([np.ones_like(xn), 2 * xn - 1,
                      6 * xn**2 - 6 * xn + 1,
                      (2 * xn - 1) ** 3 - 0.6 * (2 * xn - 1)], axis=1)
    basis /= np.linalg.norm(basis, axis=0, keepdims=True)
    print("smallest-|l| negative modes (pressure structure):")
    for j in range(min(12, len(order))):
        k = order[j]
        lam = w_all[k]
        v = VM @ (np.sqrt(wM) * (VM.T @ V_all[:, k]))  # back to x-space
        vp = v[2 * ns: 2 * ns + st.np_true]
        en_p = np.linalg.norm(vp) / max(np.linalg.norm(v), 1e-30)
        vpn = vp / max(np.linalg.norm(vp), 1e-30)
        proj = basis.T @ vpn
        frac = float(np.sum(proj**2))
        wgt = vpn**2
        mx = float(wgt @ pc[:, 0]); my = float(wgt @ pc[:, 1])
        sx = float(np.sqrt(wgt @ (pc[:, 0] - mx) ** 2))
        sy = float(np.sqrt(wgt @ (pc[:, 1] - my) ** 2))
        print(f"  l={lam:+.4e}  |p|/|x|={en_p:.2f}  "
              f"poly(x)-energy={frac:.2f}  "
              f"loc=({mx:.2f}+-{sx:.2f}, {my:.2f}+-{sy:.2f})  coeffs="
              + " ".join(f"{c:+.2f}" for c in proj))


if __name__ == "__main__":
    main()
