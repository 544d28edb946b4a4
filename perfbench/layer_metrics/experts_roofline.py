"""The held experts' grouped products' share of their roofline in the
traced window: the needed operations of the traced segment's routed
choices (``counts/deepseek_v2.expert_flops``: the rows the layers' load
counters took in, 3 GEMMs, forward and backward) over the bf16 tensor
peak, over the device time of the grouped-product kernels
(``kernel_names/experts/``): %. The backward's recomputed forward is not
needed work, so it shows as a lower share."""

from perfbench.bench import kernel_names


def read(out, ctx):
    trace, flops = out.trace, out.layer.get("expert_flops")
    if trace is None or flops is None:
        return None
    spent = trace.op_s(kernel_names("experts"))
    return 100.0 * flops / ctx.peaks["bf16_flops_per_s"] / spent if spent > 0 else None
