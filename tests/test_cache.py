"""Persistent compile cache (SURVEY §7 'cache by topology hash').

The stamp tensors are baked into each XLA program as constants, so XLA's
persistent compilation cache keys exactly on (topology, dtype, method,
backend).  These tests run the CLI in subprocesses — the cache only matters
across processes — and assert the second run is a cache *hit* via jax's own
debug log, not wall-clock (robust under CI noise).
"""

import os
import subprocess
import sys

import pytest

from nodal_tpu.utils.gridgen import grid_csv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = """
import logging, sys
logging.basicConfig(level=logging.DEBUG)
for name in ("jax._src.compilation_cache", "jax._src.compiler"):
    logging.getLogger(name).setLevel(logging.DEBUG)
import jax
jax.config.update("jax_platforms", "cpu")
if "--include-cpu" in sys.argv:
    # Cross-process cache-hit machinery test: tests run CPU-only, so undo
    # the production default that skips persistence on the CPU backend.
    from nodal_tpu.utils import cache as _cache
    _cache._exclude_cpu_backend = lambda: None
    # Persist regardless of how fast this host compiles the program.
    _cache._MIN_COMPILE_SECS = 0
from nodal_tpu import solver_cli
solver_cli.main(["--stats", "--native", "off", sys.argv[1]])
"""


def _run(netlist_path, cache_dir, *extra):
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    env.pop("NODAL_TPU_NO_CACHE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, netlist_path, *extra],
        capture_output=True, text=True, cwd=_REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stderr


def test_second_process_hits_persistent_cache(tmp_path):
    netlist = tmp_path / "grid.csv"
    # Big enough that the main solve program clears the min-compile-time
    # persistence gate on CPU.
    netlist.write_text(grid_csv(40, 40, (0, 0), (39, 39)))
    cache_dir = str(tmp_path / "xla_cache")

    log1 = _run(str(netlist), cache_dir, "--include-cpu")
    assert "PERSISTENT COMPILATION CACHE MISS" in log1

    log2 = _run(str(netlist), cache_dir, "--include-cpu")
    assert "Persistent compilation cache hit" in log2
    # The dominant program (the fused assemble+solve) must not recompile.
    assert "PERSISTENT COMPILATION CACHE MISS" not in log2


def test_cpu_backend_excluded_by_default(tmp_path):
    """Serialized XLA:CPU executables are AOT results whose baked-in tuning
    pseudo-features (+prefer-no-scatter) warn 'could lead to ... SIGILL' on
    EVERY load — even same-host.  The production default therefore skips
    persistence for the CPU backend entirely: no cache traffic, no
    entries, no loader errors."""
    netlist = tmp_path / "grid.csv"
    netlist.write_text(grid_csv(40, 40, (0, 0), (39, 39)))
    cache_dir = str(tmp_path / "xla_cache")

    log1 = _run(str(netlist), cache_dir)
    assert "PERSISTENT COMPILATION CACHE MISS" not in log1
    log2 = _run(str(netlist), cache_dir)
    assert "Persistent compilation cache hit" not in log2
    assert "cpu_aot_loader" not in log2 and "SIGILL" not in log2
    # Only the (empty) cache directory itself may exist.
    for root, _dirs, files in os.walk(cache_dir):
        assert not files, f"unexpected cache entries: {files}"


def test_cache_disabled_by_env(tmp_path, monkeypatch):
    from nodal_tpu.utils import cache as cache_mod

    monkeypatch.setenv("NODAL_TPU_NO_CACHE", "1")
    monkeypatch.setattr(cache_mod, "_enabled_dir", None)
    assert cache_mod.enable_persistent_cache(str(tmp_path / "x")) is None
    assert not (tmp_path / "x").exists()


def test_enable_is_idempotent(tmp_path, monkeypatch):
    from nodal_tpu.utils import cache as cache_mod

    monkeypatch.setattr(cache_mod, "_enabled_dir", None)
    d = str(tmp_path / "cache")
    assert cache_mod.enable_persistent_cache(d) == d
    assert cache_mod.enable_persistent_cache(d) == d


def test_env_dir_is_the_cache_verbatim(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory exactly:
    no host salt or sub-directory, and no other directory set in code."""
    from nodal_tpu.utils import cache

    d = str(tmp_path / "c")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    monkeypatch.setattr(cache, "_enabled_dir", None)
    out = cache.enable_persistent_cache()
    assert out == d
    assert os.path.isdir(d) and os.listdir(d) == []


def test_default_dir_is_in_checkout(tmp_path, monkeypatch):
    """Without the variable the cache is <checkout>/.jax_cache (listed in
    .gitignore), the same fixed path on every run."""
    from nodal_tpu.utils import cache

    assert cache.DEFAULT_DIR == os.path.join(_REPO, ".jax_cache")
    with open(os.path.join(_REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "jc"))
    monkeypatch.setattr(cache, "_enabled_dir", None)
    assert cache.enable_persistent_cache() == str(tmp_path / "jc")


def test_cache_dir_independent_of_home_and_host(tmp_path):
    """The default location depends on the checkout alone: not on HOME
    (callers may give each run its own) and not on the host's CPU."""
    code = "from nodal_tpu.utils import cache; print(cache.DEFAULT_DIR)"
    env = dict(os.environ)
    env["HOME"] = str(tmp_path)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == os.path.join(_REPO, ".jax_cache")
