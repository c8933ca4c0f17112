"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
without accelerator hardware, and with x64 enabled so parity-vs-numpy
assertions are meaningful.  Environment must be set before jax initializes.

Tests marked ``gpu`` need the card: they skip on the CPU, and run with
``NODAL_TPU_TEST_PLATFORM=cuda python -m pytest tests/ -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Force CPU for the test suite unless NODAL_TPU_TEST_PLATFORM names the
# accelerator.  The host backend stays registered beside it: the f64
# oracles (and _cpu_device_or_none) use it.
_platform = os.environ.get("NODAL_TPU_TEST_PLATFORM", "cpu")
if "cpu" not in _platform.split(","):
    _platform += ",cpu"
os.environ["JAX_PLATFORMS"] = _platform

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def tmp_netlist(tmp_path):
    """Write netlist text to a temp CSV file and return its path."""

    def write(text: str, name: str = "netlist.csv") -> str:
        p = tmp_path / name
        p.write_text(text)
        return str(p)

    return write


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU.

    Decided here, at run time, never at import or collection: every
    xdist worker must collect the same tests.
    """
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU (compiled kernel, no interpret mode)")
