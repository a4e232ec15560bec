"""device_idle: the share of the profiled session, in %, in which no
operation ran on the card (1 - busy / window). Moves scans_per_s."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
