"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
comparison phase holds at tiny widths."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_chip_smoke_refuses_cpu():
    """No accelerator: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "platform is 'cpu'" in proc.stdout


def test_chip_smoke_compare_phase_tiny():
    """The compare phase's references agree with the timed path at tiny
    widths (on the CPU default and "highest" precision coincide)."""
    data = bench.synthetic_interactions(64, 120, 10, seed=5)
    out = chip_smoke.compare_phase(data, batch=16, dim=8, topk_batch=8,
                                   topk_items=500)
    assert out["dense_step_highest"] < 1e-4
    assert out["dense_step_default"] < 1e-4
    assert out["scores_default"] == 0.0
    assert out["topk_ids_differ_highest"] == 0
    assert out["topk_ids_differ_default"] == 0


def test_topk_agreement_rejects_rated_and_far_ids():
    """The top-k check tolerates swaps at the k-th score only."""
    import pytest

    scores = np.array([[5.0, 4.0, 3.0, 2.9995, -np.inf]])
    ref = np.array([[0, 1, 2]])
    assert chip_smoke.topk_agreement(np.array([[0, 1, 3]]), ref, scores,
                                     tau=1e-3) == 1
    with pytest.raises(SystemExit):  # beyond tolerance
        chip_smoke.topk_agreement(np.array([[0, 1, 3]]), ref, scores,
                                  tau=0.0)
    with pytest.raises(SystemExit):  # a masked (rated) item
        chip_smoke.topk_agreement(np.array([[0, 1, 4]]), ref, scores,
                                  tau=1.0)
