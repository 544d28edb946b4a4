"""The port's own spans in a traced window: the ranges that
``repro_torch.obs.trace.Tracer.span`` opens under the profiler
(``record_function``), among the trace's host events, on the clock of
the device's operations. Read by name; ns on the profiler's clock."""

from __future__ import annotations

# a simulator call's host work outside its replays (``train/trainer.py``,
# ``graphs.py``): staging, each body's warm-up and capture, evaluation, release
HOST_WORK = ("sim.prepare", "graph.warmup", "graph.capture", "sim.eval", "sim.release")


def ranges(trace, names: tuple[str, ...]) -> list[tuple[int, int]]:
    """The host ranges named one of ``names``, clipped to the window."""
    lo, hi = trace.window
    return [(max(a, lo), min(b, hi)) for n, a, b in trace.host if n in names and b > lo and a < hi]


def union(intervals) -> list[tuple[int, int]]:
    """The intervals merged where they overlap or touch, in order."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summed_s(trace, names: tuple[str, ...]) -> float | None:
    """Seconds of the ranges named one of ``names`` (summed); None without
    a trace or without such a range."""
    if trace is None:
        return None
    found = ranges(trace, names)
    return sum(b - a for a, b in found) / 1e9 if found else None


def idle_inside_s(trace, names: tuple[str, ...]) -> float | None:
    """Seconds inside the union of the ranges named one of ``names`` in
    which no device operation ran; None without a trace or without such
    a range."""
    if trace is None:
        return None
    spans = union(ranges(trace, names))
    if not spans:
        return None
    busy = union((a, b) for _, a, b in trace.clipped())
    idle, i = 0, 0
    for a, b in spans:
        idle += b - a
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            idle -= min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return idle / 1e9
