"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and each
phase function must run end to end at a tiny size when called directly
(the full sizes run only on the card)."""

import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402

TINY = {
    "batch": 8,
    "ladder": 64,
    "mesh": (6, 10),
    "big_mesh": (12, 12),
    "branch": 300,
    "mc_ladder": 32,
    "mc_samples": 64,
    "mc_mesh_samples": 16,
    "grid": 32,
    "oneshot_branch": 300,
    "cli_nodes": 400,
    "cli_h": 10,
    "rows": 4,
    "sharded_batch": 8,
    "tiers": {"ladder": "tridiag", "mesh": "sband", "branch": "schur"},
}


def _run_script(cwd, *args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py"), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_script_refuses_cpu_only(args):
    proc = _run_script(_REPO, *args)
    assert proc.returncode != 0
    assert "JAX found no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_script_alone_fails(tmp_path):
    # Without the package beside it the script cannot pass.
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_device_reports_jax_device(capsys):
    import jax

    dev = chip_smoke.phase_device(None)
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}
    with pytest.raises(SystemExit, match="JAX found no GPU"):
        chip_smoke.phase_device("gpu")


def test_phase_batched_tiny(capsys):
    assert chip_smoke.phase_batched(TINY) == {"cpu"}
    out = capsys.readouterr().out
    for tier in ("tridiag", "sband", "schur"):
        for tag in ("f32-raw", "f32-contract", "f64"):
            assert f"batched/{tier}/{tag}" in out


def test_phase_monte_carlo_tiny(capsys):
    assert chip_smoke.phase_monte_carlo(TINY) == {"cpu"}
    assert "monte_carlo/mesh" in capsys.readouterr().out


def test_phase_gradient_tiny(capsys):
    assert chip_smoke.phase_gradient(TINY) == {"cpu"}
    assert "gradient/sband" in capsys.readouterr().out


def test_phase_sensitivities_tiny(capsys):
    chip_smoke.phase_sensitivities(TINY)
    out = capsys.readouterr().out
    for name in ("sensitivities/policy", "sensitivities/device",
                 "resistance_sensitivities"):
        assert name in out


def test_phase_grid_tiny(capsys):
    chip_smoke.phase_grid(TINY)
    assert "cg_iterations=" in capsys.readouterr().out


def test_phase_oneshot_tiny(capsys):
    chip_smoke.phase_oneshot(TINY)
    out = capsys.readouterr().out
    assert "oneshot/" in out and "oneshot-cli/" in out
    assert "served_by=" in out


def test_phase_sharded_tiny(capsys):
    # Four of the suite's eight virtual CPU devices.
    chip_smoke.phase_sharded(TINY, n_dev=4)
    out = capsys.readouterr().out
    for name in ("sharded-batch/mesh", "sharded-batch/branch",
                 "sharded-grid/gspmd", "sharded-grid/halo"):
        assert name in out


def test_failed_check_raises():
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke._check("x", 2e-4, 1e-4)
    with pytest.raises(AssertionError):
        chip_smoke._check("x", float("nan"), 1e-4)
