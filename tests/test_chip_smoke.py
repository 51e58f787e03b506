"""chip_smoke.py: its device guard, its last line, its four-card
comparison (on four virtual CPU devices), and the GPU checks of its
phases c and e (marked ``gpu``; they skip without a card)."""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (None, 0)
    assert "needs a GPU" in str(exc.value.code)


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev] * count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": %d}}' % count)
    assert json.loads(line)["device"]["count"] == count


def test_four_card_phase_sharded_matches_single():
    """Phase f on 4 of the 8 virtual CPU devices at a tiny size: each
    device holds a quarter of the batch and the sharded solve matches
    the single-device one within the phase's bar."""
    d_traj, d_best = chip_smoke.four_card_phase(
        jax.devices()[:4], n_problems=8, n_points=12, n_iter=3)
    assert d_traj <= chip_smoke.SHARDED_BAR
    assert d_best <= chip_smoke.SHARDED_BAR


@pytest.fixture
def gpu_mesh():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda pytest -m gpu)")
    return chip_smoke.one_card_mesh(devs)


@pytest.mark.gpu
def test_batch_and_lookup_phases_on_gpu(gpu_mesh):
    """Phases c and e at a reduced batch: f32 within 1e-3 of the f64
    engine and the oracle on the card, and exact cell gathers."""
    run, probs, out = chip_smoke.batch_phase(gpu_mesh, "gpu", batch=32,
                                             n_oracle=1, reps=1)
    chip_smoke.lookup_phase(run, probs, out)
    assert np.all(np.isfinite(np.asarray(out.traj)))
