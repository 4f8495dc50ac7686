"""chip_smoke.py: its contract off the card, and its phases at a tiny size.

On the CPU the script must refuse to run (exit non-zero, no result line), and
so must a copy that stands alone without the package. Each phase function runs
here at TINY size against the same float64 references it uses on the card; the
full-size run on the card is the ``gpu``-marked test.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run_script(cwd, extra_env=None, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_refuses_to_run_on_cpu():
    out = _run_script(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("phase", chip_smoke.PHASES,
                         ids=lambda p: p.__name__)
def test_phase_at_tiny_size(phase):
    assert chip_smoke.run_phases(chip_smoke.TINY, (phase,)) == []


@pytest.mark.parametrize("phase", chip_smoke.PHASES_FOUR,
                         ids=lambda p: p.__name__)
def test_four_device_phase_on_virtual_devices(phase):
    """The --four path on four of the suite's virtual CPU devices: sharded
    engines and transforms against float64 and against one device."""
    assert chip_smoke.run_phases(chip_smoke.TINY, (phase,)) == []


def test_failed_check_fails_the_phase(monkeypatch):
    monkeypatch.setattr(chip_smoke, "ENGINE_FLOOR", 1000.0)
    assert chip_smoke.run_phases(chip_smoke.TINY,
                                 (chip_smoke.phase_offline,)) == ["offline"]


def test_kernel_count_without_gpu_trace(tmp_path):
    assert chip_smoke.device_kernel_counts(str(tmp_path)) == (None, {})


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu):
    out = _run_script(ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
