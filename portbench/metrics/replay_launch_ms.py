"""replay_launch_ms: host ms of the step unit's ``replay.launch`` span
(``CUDAGraph.replay()`` of the step's graph), its mean."""

from portbench import spans


def read(run):
    s = spans.summary(run)
    u = spans.step_unit(s) if s is not None else None
    launch = s["host"].get(u, {}).get("replay/replay.launch") if u is not None else None
    return launch["total_ms"] / launch["count"] if launch else None
