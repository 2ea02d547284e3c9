"""step_halo_ms: device ms per step of the halo exchanges (the step unit's
``advect.<axis>/halo.<axis>`` spans: the edge copies, the NCCL sends and
receives, the concatenation); nothing where no axis is sharded."""

from portbench import spans


def read(run):
    return spans.per_step_ms(run, lambda k: k.rsplit("/", 1)[-1].startswith("halo."))
