"""bench.py's device peak table."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def test_peaks_h100_entry():
    p = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12
    assert p["hbm_bytes_per_s"] == 3.35e12


def test_peaks_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("cpu")
