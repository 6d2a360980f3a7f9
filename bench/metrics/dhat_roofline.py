"""``dhat_roofline``: the share of its bound that one ``Dhat`` of the
public operator reaches, at the cell's shape, source count and dtype:
the bound of ``bench.workmodel`` (the operation's bytes at 3.35 TB/s,
cross-checked against its flops at the f32 peak) over the CUDA-event
time, in %.  On a split lattice, rank 0's ``Dhat`` with its exchange."""


def read(run):
    if not run.dhat_s or run.dhat_bound_s is None:
        return None
    return 100.0 * run.dhat_bound_s / run.dhat_s
