"""``solve_p95_ms``: the 95th percentile (nearest rank) of every single
solve's host-clock wall time in the window."""
import math


def read(run):
    if not run.solve_s:
        return None
    ordered = sorted(run.solve_s)
    return 1e3 * ordered[math.ceil(0.95 * len(ordered)) - 1]
