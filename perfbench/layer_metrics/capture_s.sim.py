"""The port's ``graph.warmup`` and ``graph.capture`` spans in the traced
call, summed (``graphs.GraphRunner``: each body's eager first run, and
its second run, the capture and first replay): s."""

from perfbench.port_spans import summed_s


def read(out, ctx):
    return summed_s(out.trace, ("graph.warmup", "graph.capture"))
