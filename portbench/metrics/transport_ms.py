"""transport_ms: the device's busy ms per step of the traced sub-window
less the step's evals times collision_ms: the transport, the RK stages and
the monitor."""


def read(run):
    if run.profile is None or run.collision_ms is None:
        return None
    busy_ms = run.profile["busy_s"] * 1e3 / run.profile["steps"]
    return busy_ms - run.evals_per_step * run.collision_ms
