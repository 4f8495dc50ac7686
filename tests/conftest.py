"""Test configuration: run on a simulated 8-device CPU mesh with x64 available.

Tests run on CPU (deterministic, float64 oracles available); chip_smoke.py runs
the same code at full size on the GPU. Multi-device sharding tests use the 8
virtual CPU devices created here. Tests that need the card carry the ``gpu``
marker and skip here (see the ``gpu`` fixture); on the card run them with
``python -m pytest -m gpu tests/``.
"""

import os

# Must be set before jax initializes any backend.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import shutil  # noqa: E402
import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hisstools_library.utils.profiling import enable_compile_cache  # noqa: E402

# Persistent compilation cache (the suite is dominated by XLA CPU compiles of
# the sharded/scan programs); keyed by HLO hash, so it is always safe.
enable_compile_cache(min_compile_secs=1.0)


@pytest.fixture
def rng():
    return np.random.default_rng(0x1557)


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU is visible. Decided here, at run time, never
    while a test module is imported. The tests themselves stay on the CPU
    backend; what needs the card runs in a child process."""
    smi = shutil.which("nvidia-smi")
    found = False
    if smi:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                             timeout=60)
        found = out.returncode == 0 and "GPU" in out.stdout
    if not found:
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/)")
