"""replay_host_ms: the host's ms in each step call of the window (copy in,
replay, clone out; no synchronise), their mean."""


def read(run):
    return sum(run.host_call_ms) / len(run.host_call_ms) if run.host_call_ms else None
