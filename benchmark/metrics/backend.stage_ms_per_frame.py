"""Host milliseconds a window frame that the backend spent in its stages
other than solves (the stage timer of ``backend/lifelong.py`` and
``loop_closure.py``, summed over the window), ms."""

STAGES = ("kf_insert", "kf_hooks", "loop_detect", "loop_search", "loop_verify", "loc_localmap",
          "loc_register", "occ_rebuild")


def read(ctx):
    if not ctx.get("n_frames"):
        return None
    total = sum(sum(ctx["stages"].get(s, [])) for s in STAGES)
    return 1e3 * total / ctx["n_frames"]
