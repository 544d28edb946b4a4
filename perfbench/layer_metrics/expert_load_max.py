"""How unevenly the held experts are loaded: for each expert layer and each
segment read in the traced run (the layers' ``load`` counters, a device
count of the choices each held expert received, read between segments),
the largest held expert's choices over the held experts' mean; the mean
over layers and segments (1 is even)."""


def read(out, ctx):
    segments = out.layer.get("expert_loads")
    if not segments:
        return None
    ratios = [row.max() / row.mean() for seg in segments for row in seg if row.sum() > 0]
    return float(sum(ratios) / len(ratios)) if ratios else None
