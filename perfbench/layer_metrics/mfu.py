"""The model's training FLOPs over the window (``counts/``), as a share of
the tensor peak the driver names (``mfu_peak``: TF32 for the float32
simulator, since a 3xTF32 kernel can pass the float32 peak while keeping
float32's accuracy, so only the TF32 peak bounds its step; bf16 for the
LM): %. One reader for ``mfu.sim`` and ``mfu.train``."""


def read(out, ctx):
    flops = out.layer.get("model_flops_per_s")
    return None if flops is None else 100.0 * flops / ctx.peaks[out.layer["mfu_peak"]]
