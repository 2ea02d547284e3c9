"""device_idle_pct: the share of the traced sub-window in which no device
operation ran (1 - the union of their intervals over the window), mean
over the cards."""


def read(run):
    if run.profile is None or not run.profile["window_s"]:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
