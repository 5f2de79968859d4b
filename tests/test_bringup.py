"""The GPU bring-up surface, on the CPU: chip_smoke.py's device check and
phases, compile-cache placement, the roofline peak table, --shard device
checks and the stdlib CSV writer."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_argv, env_extra=None, cwd=REPO, timeout=120):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    argv = ([sys.executable, "-c", code_or_argv]
            if isinstance(code_or_argv, str) else code_or_argv)
    return subprocess.run(argv, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """On the CPU, and in a directory holding only the script, the smoke
    exits non-zero before any phase and prints no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    p = _run([sys.executable, "chip_smoke.py"], cwd=cwd)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "== phase" not in p.stdout
    if where == "repo":
        assert "needs a GPU" in p.stderr


@pytest.fixture
def no_pandas(monkeypatch):
    """The study run path must need neither pandas nor matplotlib."""
    for mod in ("pandas", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, mod, None)


def test_smoke_phase_a_cpu(tmp_path, no_pandas):
    import chip_smoke
    s, fails = chip_smoke.phase_a(0.15, str(tmp_path), artifact=None)
    assert fails == []
    assert s["columns"] == 20
    assert s["max_rel_resnorm_host_f64"] < chip_smoke.RESID_TOL
    assert s["direct_max_rel_err"] < chip_smoke.DIRECT_TOL


def test_smoke_phase_b_cpu(tmp_path, no_pandas, monkeypatch):
    import chip_smoke
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    s, fails = chip_smoke.phase_b(0.15, str(tmp_path), artifact=None)
    assert fails == []
    assert s["rows"] == 6
    for rec in s["solvers"].values():
        assert rec["stokes"]["converged"]
        assert rec["transport_max_rel_resnorm"] < chip_smoke.RESID_TOL


_REF = [{"Config": c, "CR": v, "avg_conc": "0.5"}
        for c, v in (("a", "1.0"), ("b", ""), ("c", "2.0"))]


@pytest.mark.parametrize("case", ["nan_cell", "off_by_more", "missing_row",
                                  "extra_row", "nan_resnorm", "unconverged"])
def test_smoke_checks_fail_closed(case):
    """A NaN, a missing or surplus row, or an unconverged solve fails the
    smoke's comparisons; matching rows pass (empty reference cells are
    not compared)."""
    import chip_smoke
    rows = [{"Config": "a", "CR": 1.0, "avg_conc": 0.5},
            {"Config": "b", "CR": float("nan"), "avg_conc": 0.5},
            {"Config": "c", "CR": 2.0 * (1 + 1e-9), "avg_conc": 0.5}]
    solvers = {"sulcus": {"stokes": {"converged": True},
                          "transport_max_rel_resnorm": 1e-13}}

    def compare(rs):
        return chip_smoke.compare_rows(rs, _REF, lambda r: r["Config"],
                                       ("CR", "avg_conc"))[1]

    assert compare(rows) == []
    assert chip_smoke.solver_failures(solvers) == []
    if case == "nan_cell":
        rows[0]["avg_conc"] = float("nan")
        fails = compare(rows)
    elif case == "off_by_more":
        rows[2]["CR"] = 2.0 * (1 + 1e-5)
        fails = compare(rows)
    elif case == "missing_row":
        fails = compare(rows[:2])
    elif case == "extra_row":
        fails = compare(rows + [{"Config": "d", "CR": 1.0,
                                 "avg_conc": 0.5}])
    elif case == "nan_resnorm":
        solvers["sulcus"]["transport_max_rel_resnorm"] = float("nan")
        fails = chip_smoke.solver_failures(solvers)
    else:
        solvers["sulcus"]["stokes"]["converged"] = False
        fails = chip_smoke.solver_failures(solvers)
    assert len(fails) == 1, fails
    assert chip_smoke.exceeds(float("nan"), 1.0)


@pytest.mark.gpu
def test_smoke_phase_a_gpu(gpu, tmp_path):
    """Phase A's checks at a small size on the card."""
    import chip_smoke
    s, fails = chip_smoke.phase_a(0.15, str(tmp_path), artifact=None)
    assert fails == []


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as given and no other path is
    set; without it the cache sits at the fixed path in the checkout."""
    from fenics_eff_uptake.utils.jaxconfig import REPO_CACHE_DIR
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    if not env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    code = ("import jax, jax.numpy as jnp\n"
            "from fenics_eff_uptake.utils.jaxconfig import setup, "
            "compile_cache_dir\n"
            "setup()\n"
            "jax.jit(lambda x: x * 3.0 + 1.0)(jnp.ones(7)).block_until_ready()"
            "\n"
            "print(jax.config.jax_compilation_cache_dir)\n"
            "print(compile_cache_dir())\n")
    p = _run(code, env)
    assert p.returncode == 0, p.stderr
    cfg, reported = p.stdout.split()[-2:]
    want = str(tmp_path) if env_dir else REPO_CACHE_DIR
    assert cfg == reported == want
    if env_dir:
        assert os.listdir(tmp_path), "nothing cached in the given dir"
    assert REPO_CACHE_DIR.startswith(REPO)


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "cpu"])
def test_roofline_table(kind):
    """device_kind keys the peak table; an unknown kind raises."""
    from fenics_eff_uptake.utils.roofline import (UnknownDeviceError,
                                                  chip_peaks)

    class Dev:
        device_kind = kind

    if kind.startswith("NVIDIA"):
        pk = chip_peaks(Dev())
        assert pk["kind"] == kind
        assert pk["hbm_gbps"] == 3350.0 and pk["f32_tflops"] == 67.0
        assert pk["bf16_tflops"] == 989.0 and pk["tf32_tflops"] == 495.0
        assert "data sheet" in pk["source"]
    else:
        with pytest.raises(UnknownDeviceError):
            chip_peaks(Dev())


def test_shard_needs_real_devices(monkeypatch):
    """--shard N raises when fewer than N devices exist and never
    switches platform (conftest gives 8 virtual CPU devices)."""
    import jax
    from fenics_eff_uptake.studies.common import shard_spec, use_shard_devices
    # use_shard_devices writes both variables: set them through
    # monkeypatch first so teardown restores the single-device default
    monkeypatch.setenv("FEU_SHARD", "0")
    monkeypatch.setenv("FEU_SHARD_TP", "2")
    flags = os.environ.get("XLA_FLAGS")
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        use_shard_devices(64, 2)
    assert shard_spec() is None
    assert os.environ.get("XLA_FLAGS") == flags
    assert jax.default_backend() == "cpu"
    use_shard_devices(4, 2)
    assert shard_spec() == (4, 2)


def test_shard_env_left_unset():
    """No earlier test leaks a sharded route into the single-device
    study tests (the variables are only ever set via monkeypatch)."""
    from fenics_eff_uptake.studies.common import shard_spec
    assert shard_spec() is None


def test_save_csv_matches_pandas_layout(tmp_path):
    """The stdlib writer keeps the column order, cells and float
    formatting pandas' DataFrame(rows).to_csv(index=False) wrote."""
    pd = pytest.importorskip("pandas")
    from fenics_eff_uptake.studies.common import save_csv
    rows = [
        {"Config": "a_mu_0.1x", "Pe": 0.1, "n": 3, "flag": True,
         "CR": np.nan, "x": np.float64(1) / 3, "note": None},
        {"Config": "b", "Pe": 10, "n": 4, "flag": False, "CR": 0.25,
         "x": 2.0, "extra": "late column", "mixed": 1},
        {"Config": "c", "Pe": 1.0, "n": 5, "flag": True, "CR": 1e-300,
         "x": -0.0, "mixed": "s"},
    ]
    ours = tmp_path / "ours.csv"
    theirs = tmp_path / "pandas.csv"
    out = save_csv(rows, str(ours))
    pd.DataFrame(rows).to_csv(theirs, index=False)
    assert ours.read_text() == theirs.read_text()
    assert out == rows
    # sort_by sorts the rows, columns picks and orders the columns
    save_csv(rows[::-1], str(ours), sort_by=["n"], columns=["n", "Config"])
    assert ours.read_text().splitlines() == ["n,Config", "3,a_mu_0.1x",
                                             "4,b", "5,c"]
