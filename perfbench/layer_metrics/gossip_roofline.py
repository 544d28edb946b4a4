"""The gossip kernels' share of their roofline in the traced window: the
least time of the window's mixes (``counts/gossip.py``: bytes over HBM
bandwidth or FLOPs over the tensor peak, the larger) over the device time
of the gossip kernels (``kernel_names/gossip/``): %. One reader for
``gossip_roofline.sim`` and ``gossip_roofline.train``."""

from perfbench.bench import kernel_names


def read(out, ctx):
    trace, least = out.trace, out.layer.get("mix_least_s_per_step")
    if trace is None or least is None:
        return None
    spent = trace.op_s(kernel_names("gossip"))
    return 100.0 * least * out.layer["traced_steps"] / spent if spent > 0 else None
