"""Share of the traced window in which the device ran nothing while the
port did a call's host work (``port_spans.HOST_WORK``: inside the union
of its ``sim.prepare``, ``graph.warmup``, ``graph.capture``, ``sim.eval``
and ``sim.release`` spans): %. The part of ``idle_share.sim`` that the
per-call staging, warm-ups, captures, evaluations and release cause."""

from perfbench.port_spans import HOST_WORK, idle_inside_s


def read(out, ctx):
    idle = idle_inside_s(out.trace, HOST_WORK)
    return None if idle is None or out.trace.window_s <= 0 else 100.0 * idle / out.trace.window_s
