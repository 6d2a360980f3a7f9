"""``device_idle_pct``: the share of the traced window in which rank 0's
device ran nothing: 1 - (the union of all device activity intervals in
the profiler trace) / the window's wall time, in %.  Nothing to read
where the trace holds no device activity (a run on the CPU)."""


def read(run):
    t = run.trace
    if not t or not t["device_events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
