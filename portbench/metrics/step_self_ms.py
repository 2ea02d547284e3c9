"""step_self_ms: device ms per step of the step span less its child spans
(collide, advect): the RK combinations and the record or monitor."""

from portbench import spans


def read(run):
    found = spans.step_device(run)
    return found[0]["step"]["self_ms"] / found[1] if found is not None else None
