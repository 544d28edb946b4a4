"""The MLA-and-experts LM training cell: DeepSeek-V2-Lite at one chip's
expert share, trained by the port's stacked D-SGD trainer
(``repro_torch.train.lm_trainer.make_train_setup``, n nodes on one card)
through ``TrainSetup.multi_step_fn("scan")`` in segments of captured
steps, as ``lm_train.py`` drives qwen3.

The configuration file's numbers make the port's ``deepseek-v2-lite``
config: its depth, its vocabulary slice, and the experts this chip holds
(``n_routed_experts`` of the published ``n_routed_experts_published``,
from ``first_expert``), the router keeping every published output.
Set-up, warm-up, the checked segment and the window are ``lm_train.py``'s;
the MoE layers' choices are logged (``models.moe.route_log``) across the
warm-up, the capture and the checked replay, so the checked segment's
routes are the ones its replay chose.

Correctness: the reference (``reference/deepseek_v2_lite_dsgd.py``)
follows the checked segment's steps from the same weights and batches,
with the topology it learns itself, routing each choice as the program
did, once the window has closed and the port's state is freed: each
step's loss, the norm of each weight's gradient at the segment's last
step and of its change over the segment (as ``lm_train.compare`` reads
them), and ``route_flips``, the share of the program's choices that the
reference's own float32 top-k differs from.

Per-layer inputs: the model's FLOPs (``counts/deepseek_v2.py``), the
needed operations of the traced segment's flash attention and held-expert
products, and the held experts' loads a window segment at a time (the
layers' ``load`` counters, read at each segment's end).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench.bench import (Context, Outcome, gap_checks, profiler_activities, read_trace,
                             sync)
from perfbench.counts import deepseek_v2
from perfbench.drivers.lm_train import _slice, detail as _detail, pi
from perfbench.drivers.lm_train import compare as _compare_weights
from perfbench.gen import mla_moe_weights, tokens
from perfbench.reference import deepseek_v2_lite_dsgd, stlfw


def model_config(cfg: dict):
    """The port's ModelConfig of the configuration file's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import YarnConfig

    base = get_config("deepseek-v2-lite")
    y = cfg["rope_scaling"]
    if y["type"] != "yarn" or cfg["q_lora_rank"] is not None or cfg["topk_method"] != "greedy" \
            or cfg["scoring_func"] != "softmax" or not cfg["seq_aux"]:
        raise ValueError("the port's deepseek-v2-lite runs YaRN, no q LoRA, greedy softmax "
                         "routing and the sequence-wise balance loss")
    return dataclasses.replace(
        base, num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        first_dense_layers=cfg["first_k_dense_replace"], dense_d_ff=cfg["intermediate_size"],
        rope_scaling=YarnConfig(
            factor=float(y["factor"]),
            original_max_position_embeddings=y["original_max_position_embeddings"],
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            mscale=y["mscale"], mscale_all_dim=y["mscale_all_dim"]),
        mla=dataclasses.replace(base.mla, kv_lora_rank=cfg["kv_lora_rank"],
                                qk_nope_head_dim=cfg["qk_nope_head_dim"],
                                qk_rope_head_dim=cfg["qk_rope_head_dim"],
                                v_head_dim=cfg["v_head_dim"]),
        moe=dataclasses.replace(
            base.moe, num_experts=cfg["n_routed_experts_published"],
            top_k=cfg["num_experts_per_tok"], d_ff_expert=cfg["moe_intermediate_size"],
            num_shared_experts=cfg["n_shared_experts"],
            d_ff_shared=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
            router_aux_coef=cfg["aux_loss_alpha"], norm_topk_prob=cfg["norm_topk_prob"],
            routed_scaling_factor=float(cfg["routed_scaling_factor"]),
            held_experts=cfg["n_routed_experts"], first_expert=cfg["first_expert"]))


def moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def inputs(ctx: Context) -> tuple[dict, dict]:
    """The weights (stacked over the nodes) and the pool of batches."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    params = mla_moe_weights.make(cfg, tr["n_nodes"], ctx.seed, dev,
                                  getattr(torch, cfg["torch_dtype"]))
    probs = tokens.domain_probs(cfg["vocab_size"], tr["n_nodes"], tr["zipf_a"], ctx.seed)
    pool = tokens.batches(probs, pi(tr), tr["pool_steps"], tr["per_node_batch"], tr["seq_len"],
                          dev, ctx.seed)
    return params, pool


def _flips(got: dict, ref: dict) -> float:
    """The share of the choices both sides ran on that the side which
    followed the other's routes would have chosen otherwise by its own
    float32 top-k (the side that routed itself reads 0)."""
    return float(max(got.get("route_flips", 0.0), ref.get("route_flips", 0.0)))


def compare(got: dict, ref: dict) -> dict:
    """``lm_train.compare``'s numbers, and ``route_flips`` (``_flips``)."""
    return {**_compare_weights(got, ref), "route_flips": _flips(got, ref)}


def detail(got: dict, ref: dict) -> dict:
    return {**_detail(got, ref), "route_flips": _flips(got, ref)}


class Trainer:
    """The port's stacked trainer of the cell, its multi-step function and
    the log of its routes."""

    def __init__(self, ctx: Context):
        from repro_torch.core.mixing import schedule_from_result
        from repro_torch.core.stl_fw import learn_topology
        from repro_torch.models import transformer
        from repro_torch.train.lm_trainer import make_train_setup

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.model_cfg = model_config(cfg)
        ours = {name: tuple(shape) for name, shape, _ in mla_moe_weights.shapes(cfg)}
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
        # one row a MoE call of a segment: (steps, nodes, layers) in call order
        seg, n = tr["segment_steps"], tr["n_nodes"]
        self.route_shape = (seg, n, moe_layers(cfg), tr["per_node_batch"], tr["seq_len"],
                            cfg["num_experts_per_tok"])
        self.routes = torch.zeros((seg * n * moe_layers(cfg), int(np.prod(self.route_shape[3:]))),
                                  dtype=torch.uint8, device=dev)

    def loads(self) -> np.ndarray:
        """(MoE layers, held) the held experts' choices so far (a host read)."""
        return np.stack([v.cpu().numpy() for v in self.setup.expert_loads.values()])

    def warm_up_and_check(self, params0: dict, pool: dict, seg: int) -> tuple[dict, dict, object]:
        """The segment body's eager first run, its capture (and first
        replay), on batches past the checked segment's; then the checked
        segment: the seed's weights copied into the carries and the captured
        body replayed over the pool's first ``seg`` batches. The readings
        (with the routes the replay chose), and the weights and opt state it
        leaves."""
        from repro_torch.models.moe import route_log

        with route_log(self.routes):
            p, o = params0, None
            for at in (seg, 2 * seg):
                p, o, lo = self.multi(p, o, _slice(pool, at, seg))
                lo.cpu()
            del p, o
            captures = self.multi.n_traces
            p, o, lo = self.multi(params0, None, _slice(pool, 0, seg))
            if self.multi.n_traces != captures:
                raise RuntimeError("the checked segment captured its body again")
            routes = self.routes.view(self.route_shape).clone()
        grad_norms = {k: float(g.float().norm()) for k, g in self.multi.grads.items()}
        change = {k: float((p[k].float() - params0[k].float()).norm()) for k in params0}
        losses = [float(v) for v in lo.cpu()]
        return ({"losses": losses, "grad_norms": grad_norms, "change_norms": change,
                 "routes": routes}, p, o)


def reference(ctx: Context, prec: str = "bfloat16", fault: str | None = None,
              routes: torch.Tensor | None = None) -> dict:
    """The reference's readings over the checked segment, from the seed's
    weights and batches, with a topology learnt again from Pi, routed as
    ``routes`` says (None: its own top-k)."""
    cfg, tr = ctx.config, ctx.traffic
    seg = tr["segment_steps"]
    params0, pool = inputs(ctx)
    coeffs, perms, _ = stlfw.learn(pi(tr), tr["budget"])
    W = torch.as_tensor(stlfw.matrix(coeffs, perms), dtype=torch.float32, device=ctx.device)
    first = {k: v[:seg] for k, v in pool.items()}
    del pool
    return deepseek_v2_lite_dsgd.readings(params0, first, W, cfg, cfg["lr"], seg, prec, fault,
                                          routes)


def run(ctx: Context) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    seg = tr["segment_steps"]
    with ctx.spans.span("bench.setup.trainer"):
        trainer = Trainer(ctx)
    ctx.say(f"# transport gossip_schedule (stacked, a static schedule); lmo "
            f"{trainer.result.lmo_backend}; atoms {trainer.schedule.n_atoms} "
            f"({trainer.schedule.n_communication_atoms} communicating); experts held "
            f"{cfg['n_routed_experts']} of {cfg['n_routed_experts_published']} from "
            f"{cfg['first_expert']}")
    with ctx.spans.span("bench.setup.inputs"):
        params0, pool = inputs(ctx)
    with ctx.spans.span("bench.setup.warmup_check"):
        got, p, o = trainer.warm_up_and_check(params0, pool, seg)
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

    loads, before = [], None
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

    trace, traced_rows = None, None
    if ctx.trace:
        # the held experts' loads a segment at a time, read between segments
        before = trainer.loads()
        for _ in range(2):
            p, o, lo = trainer.multi(p, o, _slice(pool, at, seg))
            lo.cpu()
            at += seg
            now = trainer.loads()
            loads.append(now - before)
            before = now
        ctx.spans.profiling = True
        with torch.profiler.profile(activities=profiler_activities(dev)) as prof:
            with ctx.spans.span("bench.traced"):
                p, o, lo = trainer.multi(p, o, _slice(pool, at, seg))
                lo.cpu()
        ctx.spans.profiling = False
        now = trainer.loads()
        loads.append(now - before)
        traced_rows = int(loads[-1].sum())
        trace = read_trace(prof, "bench.traced")
        del prof
    captures = trainer.multi.n_traces
    del trainer, p, o, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(ctx, routes=got["routes"].to(dev))
    numbers = compare(got, ref)
    ctx.say(f"# compared: {numbers}")
    checks = gap_checks(numbers, tr["limits"])
    sequences = tr["n_nodes"] * tr["per_node_batch"] * seg
    return Outcome(
        attempted=segments + failed, failed=failed,
        end_to_end={"train_tokens_per_s": tokens_done / window_s,
                    "train_peak_gib": window_peak / 2 ** 30},
        layer={"captures_train": captures,
               "model_flops_per_s": deepseek_v2.train_flops_per_token(cfg, tr["seq_len"])
               * tokens_done / window_s, "mfu_peak": "bf16_flops_per_s",
               "traced_steps": seg,
               "flash_flops": deepseek_v2.flash_flops(cfg, sequences, tr["seq_len"]),
               "expert_flops": None if traced_rows is None
               else deepseek_v2.expert_flops(cfg, traced_rows),
               "expert_loads": loads},
        checks=checks, memory_peak_bytes=int(max(setup_peak, window_peak)), window_start=t0,
        trace=trace)


def calibrate(ctx: Context, modes: list[str]) -> dict:
    """For one seed: the numbers compared of the port (``"program"``: the
    bfloat16 reference routed as the port routed), of the control
    (``"control"``: the reference in fp8 in the port's place) and of each
    fault planted in the reference (``"fault:<name>"``), these two routed
    as the bfloat16 reference routes itself. The port's trainer is freed
    before its reference runs (both do not fit the card at once)."""
    out = {}
    tic = time.perf_counter()
    if "program" in modes:
        trainer = Trainer(ctx)
        params0, pool = inputs(ctx)
        got, _, _ = trainer.warm_up_and_check(params0, pool, ctx.traffic["segment_steps"])
        del trainer, params0, pool, _
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference(ctx, routes=got["routes"].to(ctx.device))
        out["program"] = compare(got, ref)
        out["program_detail"] = detail(got, ref)
    out["reference_s"] = time.perf_counter() - tic
    others = [m for m in modes if m == "control" or m.startswith("fault:")]
    ref = reference(ctx) if others else None
    for mode in others:
        fault = mode[len("fault:"):] if mode != "control" else None
        other = reference(ctx, "fp8" if mode == "control" else "bfloat16", fault,
                          routes=ref["routes"])
        out[mode] = compare(other, ref)
        if mode == "control":
            out["control_detail"] = detail(other, ref)
    return out
