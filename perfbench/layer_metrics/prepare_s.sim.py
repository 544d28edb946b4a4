"""The port's ``sim.prepare`` span in the traced call (``train/trainer.py``:
the call's staging before its first segment -- node data, model, runner,
mixing operands, minibatch indices and test set on the device): s."""

from perfbench.port_spans import summed_s


def read(out, ctx):
    return summed_s(out.trace, ("sim.prepare",))
