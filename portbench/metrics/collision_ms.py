"""collision_ms: ms per call of the step's own operator ``collide_fn(f,
pre)`` at the step's batch shape, CUDA events around back-to-back calls
after the window (mean over the cards)."""


def read(run):
    return run.collision_ms
