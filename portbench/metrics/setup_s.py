"""setup_s: from the start of the run's first process to the first timed
dispatch: imports, the kernel library's load (its build on a first run),
the operator's tables, the inputs, the capture and one replay."""


def read(run):
    return run.setup_s
