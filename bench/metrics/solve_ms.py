"""``solve_ms``: the window's wall time over the solves it completed (a
block of sources counts as one solve), on the host clock."""


def read(run):
    if not run.solve_s:
        return None
    return 1e3 * run.window_s / len(run.solve_s)
