"""chip_smoke.py refuses to run without a GPU and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_device_guard_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        chip_smoke.require_gpu()


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    p = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_exits_nonzero_alone(tmp_path):
    """Copied without the repository it fails and prints no result."""
    script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path), script)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_phase_checks():
    import numpy as np

    gold = np.full((16, 16, 3), 100, np.uint8)
    near = gold.copy()
    near[0, 0, 0] = 101
    assert chip_smoke.deterministic_ok(near, gold)["ok"]
    far = gold.copy()
    far[0, 0, 0] = 103
    assert not chip_smoke.deterministic_ok(far, gold)["ok"]
    assert chip_smoke.stochastic_ok(near, gold)["ok"]
    assert not chip_smoke.stochastic_ok(gold + 9, gold)["ok"]
