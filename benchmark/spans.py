"""What the readers of the program's spans share.

The program's ``StageTimer`` records each span as its duration in seconds
with ``start_ns``, the Unix time in ns at which it began (the clock
``torch.profiler`` stamps its host and device events with), and ``thread``.
``ctx["stages"]`` holds the window's spans of every label. In a traced run the
profiled frames run slower; they are the frames whose spans overlap the
trace, from its first event's start to its last event's end. A span without
``start_ns`` (a program that records durations only) is never read.
"""
from benchmark.harness import union_seconds


def interval(span):
    """(start ns, end ns) of a span, or None where it has no start."""
    start = getattr(span, "start_ns", None)
    return None if start is None else (start, start + round(span * 1e9))


def traced_range(ctx):
    """(first start, last end) in ns of the trace's events; None without a
    trace or events."""
    trace = ctx.get("trace")
    events = [e for kind in ("device", "runtime", "cpu") for e in (trace or {}).get(kind, [])]
    if not events:
        return None
    return min(s for _, s, _, _ in events), max(s + d for _, s, d, _ in events)


def spans(ctx, label, profiled=False):
    """The window's (span, start ns, end ns) of ``label`` outside the
    profiled frames, or with ``profiled`` among them (none without a trace)."""
    rng = traced_range(ctx)
    out = []
    for span in ctx.get("stages", {}).get(label, []):
        iv = interval(span)
        if iv is None:
            continue
        among = rng is not None and iv[0] <= rng[1] and iv[1] >= rng[0]
        if among == profiled:
            out.append((span, *iv))
    return out


def per_frame_ms(ctx, label):
    """Milliseconds of ``label`` a window frame, outside the profiled
    frames: its spans summed over the frames counted."""
    frames, xs = spans(ctx, "frame"), spans(ctx, label)
    if not frames or not xs:
        return None
    return 1e3 * sum(s for s, _, _ in xs) / len(frames)


def covered_ns(start, end, intervals):
    """ns of [start, end) covered by the union of (start, end) intervals."""
    clipped = [(max(s, start), min(e, end) - max(s, start)) for s, e in intervals
               if s < end and e > start]
    return union_seconds(clipped) * 1e9
