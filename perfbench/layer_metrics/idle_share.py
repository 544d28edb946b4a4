"""Share of the traced window in which no kernel, copy or set ran on the
device (one minus the union of their intervals): %. One reader for
``idle_share.sim`` and ``idle_share.train``."""


def read(out, ctx):
    trace = out.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
