"""halo_ms: device ms per step of the NCCL kernels in the traced
sub-window (the halo exchange, with the time a card waits in it for its
neighbours), mean over the cards; nothing where no NCCL kernel ran."""


def read(run):
    if run.profile is None or not run.profile["nccl_s"]:
        return None
    return run.profile["nccl_s"] * 1e3 / run.profile["steps"]
