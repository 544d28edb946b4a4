"""The flash kernels' share of their roofline in the traced window: the
needed operations of the traced segment's attention at the published head
dims (``counts/deepseek_v2.flash_flops``: forward and backward, causal
pairs) over the bf16 tensor peak, over the device time of the flash
forward and backward kernels (``kernel_names/flash/``): %. The kernels
multiply zero-padded heads, so the padding's cost shows as a lower share."""

from perfbench.bench import kernel_names


def read(out, ctx):
    trace, flops = out.trace, out.layer.get("flash_flops")
    if trace is None or flops is None:
        return None
    spent = trace.op_s(kernel_names("flash"))
    return 100.0 * flops / ctx.peaks["bf16_flops_per_s"] / spent if spent > 0 else None
