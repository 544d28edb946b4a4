"""Roofline bounds over the dry run's records (``launch/dryrun.py``), on
the H100 SXM datasheet's constants (``launch/mesh.H100``).

Per (arch x shape x mesh) three lower bounds on a step's time:

    compute    = model FLOPs of the step / (cards * 989e12)
    memory     = a card's HBM bytes for the step / 3.35e12
    collective = sum over mesh axes of a card's received bytes on the axis
                 / (450e9 NVLink if the axis's group fits in one 8-GPU
                    node, else 50e9, one 400 Gb/s NIC)

They are bounds from datasheet constants, not measured times.

Sources, as the reference's (``repro/launch/roofline.py``):
  * FLOPs: the analytic model FLOPs (6 N_active T for training plus the
    attention's 12 T ctx H Dh a layer, 2 N_active T + 4 T ctx H Dh for a
    prefill, 2 N_active B + 4 B ctx H Dh a layer for a decode step); the
    dry run's counted FLOPs (``FlopCounterMode`` and the kernels' formula,
    a rank's, times the cards) stand beside them, and their ratio is the
    recomputation / loop check. The parameter counts come from the port's
    meta models (``models.common.active_param_count``).
  * bytes: the reference's analytic traffic model (parameters, activation
    streams, the cache read by a decode step: the dry run's argument
    bytes less the parameters).
  * collective bytes: the dry run's bytes a rank receives, by mesh axis,
    from the port's collectives (no HLO).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dryrun experiments/torch/dryrun --out experiments/torch/roofline.md
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os

from repro_torch.configs import INPUT_SHAPES, get_config

from .mesh import H100, MESHES

__all__ = ["param_counts", "analytic_flops", "analytic_bytes_per_device", "axis_bandwidth",
           "roofline_row", "fmt_s", "main"]

_COUNTS_CACHE: dict[str, tuple[int, int]] = {}



def param_counts(arch: str) -> tuple[int, int]:
    """(total, active) parameter counts of the full config, from a meta model."""
    if arch in _COUNTS_CACHE:
        return _COUNTS_CACHE[arch]
    from repro_torch.models import transformer, whisper
    from repro_torch.models.common import active_param_count

    cfg = get_config(arch)
    meta = whisper.Whisper(cfg, "meta") if cfg.arch_type == "audio" else \
        transformer.LM(cfg, "meta")
    total = sum(p.numel() for p in meta.parameters())
    active = active_param_count(meta, cfg)
    _COUNTS_CACHE[arch] = (total, active)
    return total, active


def analytic_flops(arch: str, shape_name: str) -> float:
    """Whole-step model FLOPs (all cards), the standard accounting."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    B, S = shape["global_batch"], shape["seq_len"]
    _, active = param_counts(arch)
    H, Dh, L = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    n_attn = sum(1 for i in range(L) if cfg.kind(i) in ("attn", "local_attn"))

    def attn_ctx(kind: str) -> float:  # the mean causal context of a query
        if kind == "local_attn":
            return 0.5 * min(S, cfg.sliding_window)
        return 0.5 * S

    attn_ctx_sum = sum(attn_ctx(cfg.kind(i)) for i in range(L)
                       if cfg.kind(i) in ("attn", "local_attn"))
    if shape["kind"] == "train":
        T = B * S
        return 6.0 * active * T + 12.0 * T * H * Dh * attn_ctx_sum
    if shape["kind"] == "prefill":
        T = B * S
        return 2.0 * active * T + 4.0 * T * H * Dh * attn_ctx_sum
    ctx = S if shape["kind"] == "decode" else min(S, cfg.long_context_window)
    return 2.0 * active * B + 4.0 * n_attn * B * ctx * H * Dh


def analytic_bytes_per_device(arch: str, shape_name: str, rec: dict, chips: int) -> float:
    """A card's HBM traffic for one step (the reference's model)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    B, S = shape["global_batch"], shape["seq_len"]
    total, _ = param_counts(arch)
    dt = 2  # bf16
    if shape["kind"] == "train":
        n_nodes = 16 if rec.get("mode") == "dsgd" else rec.get("n_nodes", 1)
        reps = n_nodes if rec.get("mode", "").startswith("dsgd") else 1
        params_dev = total * dt * reps / chips
        param_traffic = 6.0 * params_dev
        act_traffic = 20.0 * cfg.num_layers * (B * S * cfg.d_model * dt) / chips * 3
        loss_traffic = 4.0 * B * S * cfg.vocab_size * dt / chips
        return param_traffic + act_traffic + loss_traffic
    if shape["kind"] == "prefill":
        params_dev = total * dt / chips
        act = 12.0 * cfg.num_layers * B * S * cfg.d_model * dt / chips
        return 2.0 * params_dev + act
    params_dev = total * dt / chips
    cache = 0.0
    if shape["kind"] == "decode":
        cache = max(rec.get("memory", {}).get("argument_bytes", 0) - params_dev, 0.0)
    return 2.0 * params_dev + cache


def axis_bandwidth(mesh: str, axis: str) -> float:
    """Bytes/s a card receives on ``axis``'s group: NVLink where the group
    lies in one node of ``gpus_per_node`` cards (row-major ranks: the
    axis's size times the product of the later axes' sizes fits), else
    the network."""
    shape, names = MESHES[mesh]
    if axis not in names:
        return H100["net_bw"]
    span = math.prod(shape[names.index(axis):])
    return H100["nvlink_bw"] if span <= H100["gpus_per_node"] else H100["net_bw"]


def roofline_row(rec: dict) -> dict | None:
    """A record's bounds, with the reference's row keys (None for a failed
    or skipped combo, or one run at another config or shape than the
    full config at ``INPUT_SHAPES``)."""
    if rec.get("status") != "ok" or rec.get("custom"):
        return None
    arch, shape_name = rec["arch"], rec["shape"]
    chips = math.prod(MESHES[rec["mesh"]][0])
    flops = analytic_flops(arch, shape_name)
    t_compute = flops / (chips * H100["peak_flops_bf16"])
    bytes_dev = analytic_bytes_per_device(arch, shape_name, rec, chips)
    t_memory = bytes_dev / H100["hbm_bw"]
    by_axis = rec["collectives"].get("by_axis", {})
    t_coll = sum(b / axis_bandwidth(rec["mesh"], a) for a, b in by_axis.items())
    coll_dev = rec["collectives"]["total_bytes"]
    total, active = param_counts(arch)
    counted_dev = rec["cost"]["flops_per_device"]
    trip = rec.get("scan_trip", 1)
    counted = counted_dev * max(trip, 1) * chips
    ratio = flops / counted if counted else float("nan")
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    advice = {
        "compute": "raise arithmetic efficiency (tensor-core tiles, fused kernels) or shrink "
                   "redundant compute (remat policy)",
        "memory": "cut HBM traffic: fused kernels, bf16 end-to-end, chunked loss/attention "
                  "streaming",
        "collective": "cut collective volume: sparser gossip schedule (smaller d_max), overlap "
                      "collectives with compute, keep tensor parallelism inside a node",
    }[dominant]
    return {
        "arch": arch, "shape": shape_name, "mesh": rec["mesh"],
        "mode": rec.get("mode", ""),
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant,
        "model_flops": flops,
        "hlo_flops_corrected": counted,
        "flops_ratio": ratio,
        "params_total": total, "params_active": active,
        "coll_bytes_dev": coll_dev,
        "temp_gib_dev": rec["memory"]["temp_bytes"] / 2**30,
        "args_gib_dev": rec["memory"]["argument_bytes"] / 2**30,
        "advice": advice,
    }


def fmt_s(x: float) -> str:
    if x >= 1e-1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Roofline bounds over the dry run's records.")
    ap.add_argument("--dryrun", default=os.path.join("experiments", "torch", "dryrun"))
    ap.add_argument("--out", default=os.path.join("experiments", "torch", "roofline.md"))
    ap.add_argument("--mesh", default=None, choices=[None, "16x16", "2x16x16"])
    ap.add_argument("--card", default=None,
                    help="the card's `nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader` line, printed beside the table")
    args = ap.parse_args(argv)

    rows = []
    for f in sorted(glob.glob(os.path.join(args.dryrun, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if args.mesh and rec.get("mesh") != args.mesh:
            continue
        row = roofline_row(rec)
        if row:
            rows.append(row)
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    c = H100
    lines = [
        f"# Roofline bounds (NVIDIA H100 SXM datasheet: {c['peak_flops_bf16'] / 1e12:.0f} "
        f"TFLOP/s dense bf16, {c['hbm_bw'] / 1e12:.2f} TB/s HBM3, {c['nvlink_bw'] / 1e9:.0f} "
        f"GB/s NVLink a direction within {c['gpus_per_node']} GPUs, "
        f"{c['net_bw'] / 1e9:.0f} GB/s network a GPU)",
        "",
        "Lower bounds on a step's time from the datasheet's constants and the dry run's "
        "records (`python -m repro_torch.launch.dryrun --both-meshes --subprocess`, then "
        "`python -m repro_torch.launch.roofline`); not measured times. Card beside the "
        f"constants: {args.card or 'not named'}.",
        "",
        "| arch | shape | mesh | mode | compute | memory | collective | dominant | MODEL_FLOPS "
        "| MF/counted | mem GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['mode']} "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {r['model_flops']:.2e} | {r['flops_ratio']:.2f} "
            f"| {r['args_gib_dev'] + r['temp_gib_dev']:.1f} |"
        )
    lines.append("")
    lines.append("## Bottleneck advice (one line per combo)")
    for r in rows:
        lines.append(f"- **{r['arch']} x {r['shape']} ({r['mesh']})**: {r['dominant']}-bound "
                     f"-> {r['advice']}")
    out_text = "\n".join(lines)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out_text + "\n")
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(rows, f, indent=1)
    print(out_text)


if __name__ == "__main__":
    main()
