"""The FFT-method work count and the peaks behind the rooflines."""

import math

import pytest

from portbench import work

BKW64 = {"nv": 64, "ns": 12, "n_radial": 64, "antipodal": True, "dtype": "float64"}
TG16 = {"nv": 16, "ns": 12, "n_radial": 16, "antipodal": True, "dtype": "float64"}


def test_nodes_and_groups():
    assert work.quadrature_nodes(BKW64) == (384, 64)
    assert work.quadrature_nodes(TG16) == (96, 16)
    assert work.quadrature_nodes(dict(TG16, antipodal=False)) == (192, 16)


@pytest.mark.parametrize("config, batch, flops, least_ms", [
    # (3 + 2*384 + 64) transforms of 5 n log2 n, n = 64^3
    (BKW64, 1, 835 * 5 * 64**3 * 18, 0.294031666),
    # 256 cells of (3 + 2*96 + 16) transforms, n = 16^3
    (TG16, 256, 256 * 211 * 5 * 16**3 * 12, 0.198134),
])
def test_eval_flops_and_least_time(config, batch, flops, least_ms):
    assert work.eval_flops(config, batch) == pytest.approx(flops, rel=1e-15)
    assert work.least_seconds(config, batch) * 1e3 == pytest.approx(least_ms, rel=1e-6)
    # compute bound: f and Q over the bandwidth take far less
    assert work.eval_bytes(config, batch) / work.PEAK_BYTES_PER_S < 0.05 * work.least_seconds(config, batch)


def test_bytes_count_f_in_and_q_out():
    assert work.eval_bytes(BKW64) == 2 * 64**3 * 8
    assert work.eval_bytes(dict(TG16, dtype="float32"), 256) == 2 * 256 * 16**3 * 4


def test_peaks_are_the_published_h100_numbers():
    assert work.PEAK_FLOPS["float64"] == 67e12
    assert work.PEAK_BYTES_PER_S == 3.35e12
    assert math.isclose(work.PEAK_FLOPS["float32"], 495e12)
