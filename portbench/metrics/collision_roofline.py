"""collision_roofline: the least time of one eval's work by the FFT method
(``portbench/work.py``: flops over the precision's peak, or f and Q over
the bandwidth) as a share of collision_ms."""

from portbench import work


def read(run):
    if not run.collision_ms:
        return None
    return 100.0 * work.least_seconds(run.config, run.batch) * 1e3 / run.collision_ms
