"""step_advect_ms: device ms per step of the transport's advection
substeps (the step unit's ``step/advect.<axis>`` spans, their halo
exchanges included); nothing where the step advects nothing."""

from portbench import spans


def read(run):
    return spans.per_step_ms(run, lambda k: k.startswith("step/advect."))
