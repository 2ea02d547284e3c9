"""step_collide_ms: device ms per step of the collision evals inside the
step's graph (the step unit's ``step/collide`` spans, marked at the
operator's entry by ``boltzfft_torch.obs``)."""

from portbench import spans


def read(run):
    return spans.per_step_ms(run, lambda k: k == "step/collide")
