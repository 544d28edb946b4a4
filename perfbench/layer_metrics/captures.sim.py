"""CUDA-graph captures a ``run_classification`` call makes
(``logger.aux["n_traces"]``), the mean over the window's calls."""


def read(out, ctx):
    counts = out.layer.get("captures") or []
    return sum(counts) / len(counts) if counts else None
