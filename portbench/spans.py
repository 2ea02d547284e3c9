"""What the span and counter metrics read: ``boltzfft_torch.obs.summary()``
stored on ``run.spans`` by a run that had obs on over its traced
sub-window, else the program's summary as it stands when the line is made
(its counters are always on; its spans only while obs is on), else nothing,
for a program without ``obs``.  The step unit is the program's replayed
unit that the window drives (``solvers.Unit.step``)."""

#: The names of the program's step units: the relaxation's, the spatial
#: solvers' step body and the sharded steps (``_graph.Replayed`` names them).
STEP_UNITS = ("relaxation.step", "step_body", "sharded_step_2d", "sharded_step_3d")


def summary(run):
    s = getattr(run, "spans", None)
    if s is not None:
        return s
    try:
        from boltzfft_torch import obs
    except ImportError:
        return None
    return obs.summary()


def step_unit(s):
    seen = set(s["counters"]["captures"]) | set(s["device"]) | set(s["host"])
    return next((u for u in STEP_UNITS if u in seen), None)


def step_device(run):
    """``(spans, steps)``: the step unit's device spans (``"<parent>/<name>"``
    -> count, total_ms, max_ms, self_ms) and its ``step`` spans' count;
    None where no step span was read."""
    s = summary(run)
    u = step_unit(s) if s is not None else None
    spans = s["device"].get(u, {}) if u is not None else {}
    steps = spans.get("step", {}).get("count", 0)
    return (spans, steps) if steps else None


def per_step_ms(run, match) -> float:
    """Device ms per step of the step unit's spans whose key ``match``es;
    None where no step or no such span was read."""
    found = step_device(run)
    if found is None:
        return None
    spans, steps = found
    keys = [k for k in spans if match(k)]
    return sum(spans[k]["total_ms"] for k in keys) / steps if keys else None


def step_counter(run, kind: str):
    """The step unit's counter ``kind`` (``captures``, ``graph_nodes``)."""
    s = summary(run)
    u = step_unit(s) if s is not None else None
    return s["counters"][kind].get(u) if u is not None else None
