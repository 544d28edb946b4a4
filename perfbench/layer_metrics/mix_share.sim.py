"""The gossip kernels' (``kernel_names/gossip/``) device time over all
device time in the traced window: %."""

from perfbench.bench import kernel_names


def read(out, ctx):
    trace = out.trace
    if trace is None:
        return None
    total = trace.op_s()
    spent = trace.op_s(kernel_names("gossip"))
    return 100.0 * spent / total if total > 0 and spent > 0 else None
