#!/usr/bin/env bash
# CI-style smoke check: fast correctness gate for every commit.
#
# Runs on CPU (tests/conftest.py selects the CPU + x64 + an
# 8-virtual-device mesh), so it exercises the full stack -- mesher,
# native Delaunay kernel, assembly, batched Krylov, two-level
# preconditioner, sharding, studies, analysis -- without a GPU
# (`python chip_smoke.py` is the run on the card).
#
# Usage:
#   scripts/smoke.sh          # fast subset (~2 min)
#   scripts/smoke.sh full     # entire pyramid + golden staleness check
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== import + version =="
python -c "import fenics_eff_uptake as m; print(m.__name__, 'ok')"

echo "== graft entry compile-check (CPU) =="
JAX_PLATFORMS=cpu python - <<'EOF'
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
jax.block_until_ready(out)
print("entry() ok")
EOF

if [[ "${1:-fast}" == "full" ]]; then
    echo "== full test pyramid =="
    python -m pytest tests/ -x -q
    echo "== golden staleness =="
    python scripts/refresh_goldens.py --check
    echo "== multichip dryrun (8 virtual devices) =="
    python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
else
    echo "== fast test subset =="
    python -m pytest tests/test_meshing.py tests/test_fem.py \
        tests/test_analysis.py tests/test_solvers.py \
        tests/test_params.py -x -q
fi

echo "SMOKE OK"
