"""``iters``: Krylov iterations per solve, the mean over the window's
solves of ``SolveResult.iterations`` (for a block, its largest column)."""


def read(run):
    if not run.iterations:
        return None
    return sum(run.iterations) / len(run.iterations)
