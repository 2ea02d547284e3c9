"""device_peak_gib: ``torch.cuda.max_memory_reserved()`` from the process
start to the window's end, on the fullest card."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
