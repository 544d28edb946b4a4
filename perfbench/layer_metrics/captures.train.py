"""CUDA-graph captures of the LM trainer's multi-step function
(``multi.n_traces``) at the window's close, set-up's included."""


def read(out, ctx):
    return out.layer.get("captures_train")
