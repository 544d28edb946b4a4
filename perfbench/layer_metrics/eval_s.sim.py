"""The port's ``sim.eval`` spans in the traced call, summed
(``train/trainer.py``: the test-set forward, the accuracies' host copy
and the consensus distance of each evaluation): s."""

from perfbench.port_spans import summed_s


def read(out, ctx):
    return summed_s(out.trace, ("sim.eval",))
