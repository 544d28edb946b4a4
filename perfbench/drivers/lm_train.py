"""The LM training cell: the port's stacked D-SGD trainer
(``repro_torch.train.lm_trainer.make_train_setup``, n nodes on one card)
driven through ``TrainSetup.multi_step_fn("scan")`` in segments of
captured steps.

Set-up builds the trainer, makes the weights and a pool of token batches
on the card from the seed (``gen/``), and drives the one multi-step
function the window then uses: a segment that warms the segment's body up,
one that captures it (and replays it), then the checked segment: the
seed's weights copied back into the carries and a replay of the captured
body over the pool's first segment of batches. The window carries on from
there, segment after segment of the pool, in order and round again; a
segment started inside the window is finished, its losses copied to the
host, and counted with its time.

Correctness: the reference (``reference/qwen3_dsgd.py``) follows the
checked segment's steps from the same weights and batches, with the
topology it learns itself, once the window has closed and the port's
state is freed: each step's loss, the norm of each weight's gradient at
the segment's last step (the port's, as the replay left it in the
multi-step function's gradient buffers: the only step whose gradient a
captured body keeps) and of each weight's change over the segment.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench.bench import (Context, Outcome, gap_checks, profiler_activities, read_trace,
                             sync)
from perfbench.counts import gossip, qwen3
from perfbench.gen import tokens, weights
from perfbench.reference import qwen3_dsgd, stlfw



def model_config(cfg: dict):
    """The port's ModelConfig of the configuration file's numbers."""
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("qwen3-0.6b"), num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], attn_bias=cfg["attention_bias"],
        qk_norm=True, mlp_type="swiglu", dtype=cfg["torch_dtype"])


def pi(traffic: dict) -> np.ndarray:
    if traffic["pi"] != "identity":
        raise ValueError(f"unknown Pi {traffic['pi']!r}")
    return np.eye(traffic["n_nodes"])


def inputs(ctx: Context) -> tuple[dict, dict]:
    """The weights (stacked over the nodes) and the pool of batches."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    params = weights.make(cfg, tr["n_nodes"], ctx.seed, dev, getattr(torch, cfg["torch_dtype"]))
    probs = tokens.domain_probs(cfg["vocab_size"], tr["n_nodes"], tr["zipf_a"], ctx.seed)
    pool = tokens.batches(probs, pi(tr), tr["pool_steps"], tr["per_node_batch"], tr["seq_len"],
                          dev, ctx.seed)
    return params, pool


def _slice(pool: dict, start: int, k: int) -> dict:
    idx = (start + torch.arange(k, device=pool["tokens"].device)) % pool["tokens"].shape[0]
    return {name: v.index_select(0, idx) for name, v in pool.items()}


def _weight_gaps(got: dict, ref: dict) -> tuple[dict, dict, float, float]:
    """Each weight's gap of gradient and of change norms, over the larger of
    its reference norm and the median weight's; a weight whose reference
    gradient is under a thousandth of the median weight's moves by
    round-off alone and is left out of the change."""
    g_ref, c_ref = ref["grad_norms"], ref["change_norms"]
    g_med = float(np.median(list(g_ref.values())))
    c_med = float(np.median(list(c_ref.values())))
    grad = {k: abs(got["grad_norms"][k] - r) / max(r, g_med) for k, r in g_ref.items()}
    change = {k: abs(got["change_norms"][k] - c_ref[k]) / max(c_ref[k], c_med)
              for k in c_ref if g_ref[k] >= 1e-3 * g_med}
    return grad, change, g_med, c_med


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: the widest gap of a step's loss (share of the
    reference's); by the worst weight, the gap of the last step's gradient
    norm and of the change norm (``_weight_gaps``)."""
    inf = float("inf")
    if len(got["losses"]) != len(ref["losses"]):
        return {"loss_gap": inf, "grad_gap": inf, "change_gap": inf}
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    grad, change, _, _ = _weight_gaps(got, ref)
    return {"loss_gap": float(loss), "grad_gap": float(max(grad.values())),
            "change_gap": float(max(change.values()))}


def detail(got: dict, ref: dict) -> dict:
    """Where the numbers come from: each step's loss gap, and the three
    weights with the widest gradient and change gaps."""
    grad, change, g_med, c_med = _weight_gaps(got, ref)

    def worst(gaps: dict, norms: dict) -> list:
        return sorted(((v, k, norms[k]) for k, v in gaps.items()), reverse=True)[:3]

    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])],
            "grad_worst": worst(grad, ref["grad_norms"]),
            "change_worst": worst(change, ref["change_norms"]), "grad_median": g_med,
            "change_median": c_med}


class Trainer:
    """The port's stacked trainer of the cell, and its multi-step function."""

    def __init__(self, ctx: Context):
        from repro_torch.core.mixing import schedule_from_result
        from repro_torch.core.stl_fw import learn_topology
        from repro_torch.models import transformer
        from repro_torch.train.lm_trainer import make_train_setup

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.model_cfg = model_config(cfg)
        ours = {name: tuple(shape) for name, shape, _ in weights.shapes(cfg)}
        theirs = {name: tuple(p.shape) for name, p in
                  transformer.LM(self.model_cfg, "meta").named_parameters()}
        if ours != theirs:
            raise ValueError(f"the port's weights are not the checkpoint's: "
                             f"{sorted(set(ours.items()) ^ set(theirs.items()))[:4]}")
        self.result = learn_topology(pi(tr), tr["budget"])
        self.schedule = schedule_from_result(self.result)
        self.setup = make_train_setup(self.model_cfg, n_nodes=tr["n_nodes"],
                                      schedule=self.schedule, lr=cfg["lr"],
                                      momentum=cfg["momentum"], device=dev)
        self.multi = self.setup.multi_step_fn("scan")

    def warm_up(self, params0: dict, pool: dict, seg: int) -> None:
        """The segment body's eager first run, then its capture (and first
        replay), on batches past the checked segment's."""
        p, o = params0, None
        for at in (seg, 2 * seg):
            p, o, lo = self.multi(p, o, _slice(pool, at, seg))
            lo.cpu()

    def check(self, params0: dict, pool: dict, seg: int) -> tuple[dict, dict, object]:
        """The checked segment: the seed's weights copied into the carries
        and the captured body replayed over the pool's first ``seg``
        batches. The readings, and the weights and opt state it leaves."""
        captures = self.multi.n_traces
        p, o, lo = self.multi(params0, None, _slice(pool, 0, seg))
        if self.multi.n_traces != captures:
            raise RuntimeError("the checked segment captured its body again")
        grad_norms = {k: float(g.float().norm()) for k, g in self.multi.grads.items()}
        change = {k: float((p[k].float() - params0[k].float()).norm()) for k in params0}
        losses = [float(v) for v in lo.cpu()]
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}, p, o


def reference(ctx: Context, prec: str = "bfloat16", fault: str | None = None) -> dict:
    """The reference's readings over the checked segment, from the seed's
    weights and batches, with a topology learnt again from Pi."""
    cfg, tr = ctx.config, ctx.traffic
    seg = tr["segment_steps"]
    params0, pool = inputs(ctx)
    coeffs, perms, _ = stlfw.learn(pi(tr), tr["budget"])
    W = torch.as_tensor(stlfw.matrix(coeffs, perms), dtype=torch.float32, device=ctx.device)
    first = {k: v[:seg] for k, v in pool.items()}
    del pool
    return qwen3_dsgd.readings(params0, first, W, cfg, cfg["lr"], seg, prec, fault)


def run(ctx: Context) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    seg = tr["segment_steps"]
    with ctx.spans.span("bench.setup.trainer"):
        trainer = Trainer(ctx)
    ctx.say(f"# transport gossip_schedule (stacked, a static schedule); lmo "
            f"{trainer.result.lmo_backend}; atoms {trainer.schedule.n_atoms} "
            f"({trainer.schedule.n_communication_atoms} communicating)")
    with ctx.spans.span("bench.setup.inputs"):
        params0, pool = inputs(ctx)
    with ctx.spans.span("bench.setup.warmup"):
        trainer.warm_up(params0, pool, seg)
    with ctx.spans.span("bench.setup.check"):
        got, p, o = trainer.check(params0, pool, seg)
    del params0
    at = 3 * seg
    ctx.say(f"# checked segment: a replay of the captured {seg}-step body from the seed's "
            f"weights (captures {trainer.multi.n_traces})")
    if ctx.trace:  # the profiler's own start-up stays out of the traced segment
        with torch.profiler.profile(activities=profiler_activities(dev)):
            torch.ones(1, device=dev).add_(1)
    sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    segments, failed = 0, 0
    while True:
        with ctx.spans.span("bench.segment", start=at):
            try:
                p, o, lo = trainer.multi(p, o, _slice(pool, at, seg))
                lo.cpu()
            except RuntimeError as exc:
                failed += 1
                ctx.say(f"# segment at step {at} failed: {exc!r}")
                break
        at += seg
        segments += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tok_step = tr["n_nodes"] * tr["per_node_batch"] * tr["seq_len"]
    tokens_done = segments * seg * tok_step
    ctx.say(f"# window {window_s:.3f} s, {segments} segments of {seg} steps; captures "
            f"{trainer.multi.n_traces}; peak {window_peak} bytes in the window, {setup_peak} "
            f"in set-up")

    trace = None
    if ctx.trace:
        ctx.spans.profiling = True
        with torch.profiler.profile(activities=profiler_activities(dev)) as prof:
            with ctx.spans.span("bench.traced"):
                p, o, lo = trainer.multi(p, o, _slice(pool, at, seg))
                lo.cpu()
        ctx.spans.profiling = False
        trace = read_trace(prof, "bench.traced")
        del prof
    captures = trainer.multi.n_traces
    n_params = sum(int(np.prod(s)) for _, s, _ in weights.shapes(cfg))
    n_nodes, nnz = tr["n_nodes"], int(np.count_nonzero(trainer.result.W > 1e-12))
    ops_bytes = 4 * trainer.schedule.n_atoms * (n_nodes + 1)
    del trainer, p, o, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = gap_checks(compare(got, reference(ctx)), tr["limits"])
    return Outcome(
        attempted=segments + failed, failed=failed,
        end_to_end={"train_tokens_per_s": tokens_done / window_s,
                    "train_peak_gib": window_peak / 2 ** 30},
        layer={"captures_train": captures,
               "model_flops_per_s": qwen3.train_flops_per_token(cfg, tr["seq_len"])
               * tokens_done / window_s, "mfu_peak": "bf16_flops_per_s",
               "traced_steps": seg,
               "mix_least_s_per_step": gossip.mix_least_s(n_nodes, n_params, 2, ops_bytes, nnz,
                                                          ctx.peaks)},
        checks=checks, memory_peak_bytes=int(max(setup_peak, window_peak)), window_start=t0,
        trace=trace)


# calibrate.py's seeds share one trainer (their topology is the same): for
# each seed its warm-up segments and its checked segment are replays
_TRAINERS: dict = {}


def calibrate(ctx: Context, modes: list[str]) -> dict:
    """For one seed: the numbers compared of the port (``"program"``), of the
    control (``"control"``: the reference in fp8 in the port's place) and
    of each fault planted in the reference (``"fault:<name>"``), each
    against the bfloat16 reference."""
    tic = time.perf_counter()
    ref = reference(ctx)
    out = {"reference_s": time.perf_counter() - tic}
    if "program" in modes:
        trainer = _TRAINERS.get(ctx.workload) or _TRAINERS.setdefault(ctx.workload, Trainer(ctx))
        params0, pool = inputs(ctx)
        trainer.warm_up(params0, pool, ctx.traffic["segment_steps"])
        got, _, _ = trainer.check(params0, pool, ctx.traffic["segment_steps"])
        del params0, pool, _
        out["program"] = compare(got, ref)
        out["program_detail"] = detail(got, ref)
    if "control" in modes:
        ctrl = reference(ctx, "fp8")
        out["control"] = compare(ctrl, ref)
        out["control_detail"] = detail(ctrl, ref)
    for mode in modes:
        if mode.startswith("fault:"):
            out[mode] = compare(reference(ctx, fault=mode[len("fault:"):]), ref)
    return out
