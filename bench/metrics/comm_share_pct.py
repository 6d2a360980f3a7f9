"""``comm_share_pct``: the share of the traced window that NCCL kernels
cover on rank 0 (the union of their intervals over the window's wall
time), in %.  Nothing to read on one chip, or where the trace holds no
device activity."""


def read(run):
    t = run.trace
    if run.world < 2 or not t or not t["device_events"]:
        return None
    return 100.0 * t["comm_s"] / t["window_s"]
