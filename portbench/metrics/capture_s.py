"""capture_s: the first step call of the set-up (the eager warm-up and the
capture of the step's CUDA graph), host clock to a synchronise."""


def read(run):
    return run.capture_s
