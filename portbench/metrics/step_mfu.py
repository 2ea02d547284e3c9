"""step_mfu: the FFT-method flops of a step's evals (``portbench/work.py``)
per step_ms, as a share of the card's peak in the configuration's
precision.  The transport's arithmetic is not counted."""

from portbench import work


def read(run):
    if not run.steps:
        return None
    flops = run.evals_per_step * work.eval_flops(run.config, run.batch)
    step_s = run.window_s / run.steps
    return 100.0 * flops / step_s / work.PEAK_FLOPS[run.config["dtype"]]
