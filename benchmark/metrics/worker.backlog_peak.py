"""Most keyframes waiting for the backend's worker, sampled after each
frame of the window, items."""


def read(ctx):
    return float(max(ctx["backlog"])) if ctx.get("backlog") else None
