"""step_gap_us: device us from one step graph's last node to the next
one's first (the end mark of a ``step`` span to the next begin mark): the
copy-in and clone-out around the graph and the wait for its launch."""

from portbench import spans


def read(run):
    s = spans.summary(run)
    u = spans.step_unit(s) if s is not None else None
    gap = s["gaps"].get(u) if u is not None else None
    return gap["total_ms"] * 1e3 / gap["count"] if gap and gap["count"] else None
