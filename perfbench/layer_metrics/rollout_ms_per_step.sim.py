"""The port's ``sim.segment`` spans (``train/trainer.py``: a segment's
bodies and the host copy of its losses; evaluation outside) summed over
the window's calls, over the steps inside them: ms a step."""


def read(out, ctx):
    segments = out.layer.get("segments") or []
    steps = sum(k for _, k in segments)
    return 1e3 * sum(s for s, _ in segments) / steps if steps else None
