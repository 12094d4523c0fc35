"""Mean host milliseconds of a pose-graph solve in the window (the stage
timer's ``optimize_win`` and ``optimize_full``), ms; nothing where the
window holds no solve."""


def read(ctx):
    xs = ctx["stages"].get("optimize_win", []) + ctx["stages"].get("optimize_full", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
