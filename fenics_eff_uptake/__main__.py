"""Package CLI: `python -m fenics_eff_uptake <study> [...]`.

Replaces the reference's four interactive stdin menus
(no_advection_analysis_A.py:1725, no_advection_analysis_B.py:397,
no_uptake_analysis.py:1095, adv_diff_analysis.py:646) with one
non-interactive entry point (SURVEY.md 5.6 asks for a real CLI); run with
no arguments for a numbered menu like the reference's.
"""

from __future__ import annotations

import sys

from .utils.jaxconfig import setup

STUDIES = {
    "phase-a": ("Phase A: no-advection mu_eff studies "
                "(mu sweep / aspect ratio / geometry / spatial)",
                "fenics_eff_uptake.studies.phase_a"),
    "phase-b": ("Phase B: sulcus vs rectangle mu sweep",
                "fenics_eff_uptake.studies.phase_b"),
    "no-uptake": ("No-uptake geometry x Peclet flow study",
                  "fenics_eff_uptake.studies.no_uptake"),
    "adv-diff": ("Adv-diff step-mu(x) validation (Pe x mu)",
                 "fenics_eff_uptake.studies.adv_diff"),
    "mesh-convergence": ("Mesh-refinement convergence ladder",
                         "fenics_eff_uptake.studies.mesh_convergence"),
}


def _menu():
    keys = list(STUDIES)
    print("fenics-eff-uptake -- studies:")
    for i, k in enumerate(keys, 1):
        print(f"  {i}. {STUDIES[k][0]}   [{k}]")
    choice = input("Select study number (or q): ").strip()
    if choice.lower() in ("q", ""):
        return None
    try:
        return keys[int(choice) - 1]
    except (ValueError, IndexError):
        print("invalid choice")
        return None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    setup(x64=True)
    if not argv:
        key = _menu()
        if key is None:
            return
        rest = []
    else:
        key, rest = argv[0], argv[1:]
    if key in ("-h", "--help"):
        print(__doc__)
        for k, (desc, _) in STUDIES.items():
            print(f"  {k:18} {desc}")
        return
    if key not in STUDIES:
        print(f"unknown study '{key}'; one of {list(STUDIES)}")
        sys.exit(2)
    import importlib
    mod = importlib.import_module(STUDIES[key][1])
    mod.main(rest)


if __name__ == "__main__":
    main()
