"""step_p95_ms: the 95th percentile of every step's time between the CUDA
events recorded on the stream between steps (on several cards each step's
slowest card)."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_ms, 95)) if run.step_ms else None
