"""The MLA-and-experts LM training cell on the CPU at a tiny DeepSeek-V2
size: the reference against the port, a whole run of the harness past its
look for a card, the control, and the faults a training step, its
captured segment or its expert layer can have, each of which has to make
``correct`` come out false.

The CPU runs float32 weights, as ``test_perfbench_lm.py`` does (there the
port sums a bfloat16 mix in bfloat16).
"""

from __future__ import annotations

import argparse

import pytest
import torch

from perfbench import bench, run
from perfbench.drivers import lm_train_moe
from perfbench.gen import mla_moe_weights
from perfbench.tests.test_perfbench_lm import FAULTS as TRAINER_FAULTS

WORKLOAD = "train.deepseek-v2-lite.n4-s4096"
CPU = torch.device("cpu")


def _small() -> tuple[dict, dict]:
    """DeepSeek-V2's form at tiny widths in float32 (1 dense + 2 expert
    layers, d 64, 4 heads of (16 + 8, 16), latent 32, 4 of 8 experts held
    from expert 2, top-3); 4 nodes, 2 x 32 tokens, segments of 2; the
    cell's limits."""
    _, cfg, tr = bench.cell(bench.benchmark(), WORKLOAD)
    cfg = dict(cfg, torch_dtype="float32", hidden_size=64, intermediate_size=96,
               moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, vocab_size=256, n_routed_experts=4, n_routed_experts_published=8,
               num_experts_per_tok=3, first_expert=2)
    return cfg, dict(tr, seq_len=32, per_node_batch=2, segment_steps=2, pool_steps=12)


def _measure(trace: int = 0) -> tuple[dict, list]:
    cfg, tr = _small()
    args = argparse.Namespace(workload=WORKLOAD, seed=2**31 + 21, seconds=0.2, trace=trace)
    return run.measure(args, CPU, config=cfg, traffic=tr)


def test_the_checkpoint_layout_is_the_ports():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    _, cfg, _ = bench.cell(bench.benchmark(), WORKLOAD)
    ours = {name: shape for name, shape, _ in mla_moe_weights.shapes(cfg)}
    port = lm_train_moe.model_config(cfg)
    theirs = {name: tuple(p.shape) for name, p in transformer.LM(port, "meta").named_parameters()}
    assert ours == theirs
    # the published model but for the cut the file lists in "reduced"
    full = get_config("deepseek-v2-lite")
    assert port == type(full)(**{**full.__dict__, "num_layers": 9, "vocab_size": 12800,
                                  "moe": type(full.moe)(**{**full.moe.__dict__,
                                                           "held_experts": 8})})


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    line, checks = _measure(trace)
    assert line["correct"], checks
    assert all(value <= limit / 10 for _, value, limit in checks), checks
    names = {m["name"] for m in bench.cell_metrics(bench.benchmark(), WORKLOAD,
                                                   "per_layer" if trace else "end_to_end")}
    assert set(line["metrics"]) <= names
    if trace:
        # on the CPU no device operation runs: the device readers find nothing
        assert {"mfu.dsv2lite", "expert_load_max.dsv2lite"} <= set(line["metrics"])
        assert line["metrics"]["expert_load_max.dsv2lite"]["value"] >= 1.0


def test_the_control_is_not_correct():
    """The reference in fp8, in the port's place, fails a limit."""
    cfg, tr = _small()
    ctx = bench.Context(WORKLOAD, 2**31 + 5, 0.0, False, CPU, cfg, tr, bench.peaks(),
                        bench.Spans())
    ref = lm_train_moe.reference(ctx)
    numbers = lm_train_moe.compare(lm_train_moe.reference(ctx, "fp8", routes=ref["routes"]),
                                   ref)
    assert not all(v <= lim for _, v, lim in bench.gap_checks(numbers, tr["limits"])), numbers


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_mix", "alter"])
def test_a_fault_in_the_reference_is_not_correct(fault):
    """Each fault planted in the reference, in the port's place, fails a limit."""
    cfg, tr = _small()
    ctx = bench.Context(WORKLOAD, 2**31 + 5, 0.0, False, CPU, cfg, tr, bench.peaks(),
                        bench.Spans())
    ref = lm_train_moe.reference(ctx)
    numbers = lm_train_moe.compare(lm_train_moe.reference(ctx, fault=fault,
                                                          routes=ref["routes"]), ref)
    assert not all(v <= lim for _, v, lim in bench.gap_checks(numbers, tr["limits"])), numbers


def _renormalised(orig):
    """The router renormalising its top-k, as the reference's MoE does."""
    def route(params, cfg, x):
        probs, gates, ids = orig(params, cfg, x)
        return probs, gates / gates.sum(-1, keepdim=True), ids
    return route


def _drops_last_expert(orig):
    """The held share dropping every choice of its last expert."""
    def sort(expert_ids, first, held):
        order, counts = orig(expert_ids, first, held)
        return order, torch.cat([counts[:-1], counts[-1:] * 0])
    return sort


def _other_share(orig):
    """The held share computed as if it began one expert later."""
    def sort(expert_ids, first, held):
        return orig(expert_ids, first + 1, held)
    return sort


def _no_aux(orig):
    def seq_aux(probs, ids, n):
        return 0.0 * orig(probs, ids, n)
    return seq_aux


MOE_FAULTS = {
    "renormalised": ("route", _renormalised),
    "drops_last_expert": ("sort_choices", _drops_last_expert),
    "other_share": ("sort_choices", _other_share),
    "no_aux": ("seq_aux_loss", _no_aux),
}


@pytest.mark.parametrize("fault", sorted(TRAINER_FAULTS) + sorted(MOE_FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.models import moe
    from repro_torch.train import lm_trainer

    if fault in MOE_FAULTS:
        name, make = MOE_FAULTS[fault]
        monkeypatch.setattr(moe, name, make(getattr(moe, name)))
    else:
        name, attr, make = TRAINER_FAULTS[fault]
        if attr is None:
            monkeypatch.setattr(lm_trainer, name, make(getattr(lm_trainer, name)))
        else:
            owner = getattr(lm_trainer, name)
            monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    line, checks = _measure()
    assert not line["correct"], checks
