"""The port's ``sim.release`` span in the traced call
(``train/trainer.py``: dropping the call's bodies, their CUDA graphs and
the graphs' memory pools): s."""

from perfbench.port_spans import summed_s


def read(out, ctx):
    return summed_s(out.trace, ("sim.release",))
