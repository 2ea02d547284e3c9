"""step_ms: the window's wall over the steps completed in it (host clock,
from a synchronise before the first dispatch to the synchronise after the
last step)."""


def read(run):
    return run.window_s * 1e3 / run.steps if run.steps else None
