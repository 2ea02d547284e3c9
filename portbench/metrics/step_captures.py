"""step_captures: captures of the step unit's CUDA graph over the run (1
where nothing rebuilt it), counted by ``boltzfft_torch.obs``."""

from portbench import spans


def read(run):
    return spans.step_counter(run, "captures")
