"""The LM training cell on the CPU at qwen3's smoke size: the reference
against the port, a whole run of the harness past its look for a card,
the control, and the faults a training step or its captured segment can
have, each of which has to make ``correct`` come out false.

The CPU runs float32 weights: there the port sums a bfloat16 mix in
bfloat16 (its card kernels sum in float32 and round once, as the
reference does), which would move every weight by a rounding of its own.
"""

from __future__ import annotations

import argparse

import pytest
import torch

from perfbench import bench, run
from perfbench.drivers import lm_train
from perfbench.gen import weights

WORKLOAD = "train.qwen3-0.6b.n4-s1024"
CPU = torch.device("cpu")


def _small() -> tuple[dict, dict]:
    """qwen3's smoke widths (2 layers, d 128, 4 / 2 heads of 32, vocab
    512) in float32; 4 nodes, 2 x 32 tokens, segments of 2; the cell's
    limits."""
    _, cfg, tr = bench.cell(bench.benchmark(), WORKLOAD)
    cfg = dict(cfg, torch_dtype="float32", hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
               vocab_size=512)
    return cfg, dict(tr, seq_len=32, segment_steps=2, pool_steps=12)


def _measure(trace: int = 0) -> tuple[dict, list]:
    cfg, tr = _small()
    args = argparse.Namespace(workload=WORKLOAD, seed=2**31 + 21, seconds=0.2, trace=trace)
    return run.measure(args, CPU, config=cfg, traffic=tr)


def test_the_checkpoint_layout_is_the_ports():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    _, cfg, _ = bench.cell(bench.benchmark(), WORKLOAD)
    ours = {name: shape for name, shape, _ in weights.shapes(cfg)}
    theirs = {name: tuple(p.shape) for name, p in
              transformer.LM(lm_train.model_config(cfg), "meta").named_parameters()}
    assert ours == theirs
    assert lm_train.model_config(cfg) == get_config("qwen3-0.6b")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    line, checks = _measure(trace)
    assert line["correct"], checks
    assert all(value <= limit / 10 for _, value, limit in checks), checks
    names = {m["name"] for m in bench.cell_metrics(bench.benchmark(), WORKLOAD,
                                                   "per_layer" if trace else "end_to_end")}
    # on the CPU no device operation runs: the device readers find nothing
    assert set(line["metrics"]) <= names and "mfu.train" in line["metrics"] or not trace
    if trace:
        assert line["metrics"]["captures.train"]["value"] == 1


def test_the_control_is_not_correct():
    """The reference in fp8, in the port's place, fails a limit."""
    cfg, tr = _small()
    ctx = bench.Context(WORKLOAD, 2**31 + 5, 0.0, False, CPU, cfg, tr, bench.peaks(),
                        bench.Spans())
    ref = lm_train.reference(ctx)
    numbers = lm_train.compare(lm_train.reference(ctx, "fp8"), ref)
    assert not all(v <= lim for _, v, lim in bench.gap_checks(numbers, tr["limits"])), numbers


def _half_batch(orig):
    def loss_grads(self, leaves, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(self, leaves, half)
    return loss_grads


def _alter(orig):
    def loss_grads(self, leaves, batch):
        return orig(self, leaves, dict(batch, labels=torch.roll(batch["labels"], 1, dims=-1)))
    return loss_grads


def _stale_carry(orig):
    """The carries bound once: a later call's weights are not copied in."""
    def bind(self, params, opt):
        if self.params is None:
            orig(self, params, opt)
    return bind


def _stale_batch(orig):
    """A body's static inputs filled at its first run only."""
    def body(self, k, batch, operand, phase):
        out = orig(self, k, batch, operand, phase)
        if out.runs:
            out.batch = {}
        return out
    return body


FAULTS = {
    "unchanged": ("_sgd_update", None, lambda orig: lambda params, grads, m, lr, mom: (params, m)),
    "stale_carry": ("_Rollout", "_bind", _stale_carry),
    "stale_batch": ("_Rollout", "_body", _stale_batch),
    "no_mix": ("_Step", "mix", lambda orig: lambda self, half, opt, op, delays: (half, None)),
    "half_batch": ("_Step", "_loss_grads", _half_batch),
    "alter": ("_Step", "_loss_grads", _alter),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.train import lm_trainer

    name, attr, make = FAULTS[fault]
    if attr is None:
        monkeypatch.setattr(lm_trainer, name, make(getattr(lm_trainer, name)))
    else:
        owner = getattr(lm_trainer, name)
        monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    line, checks = _measure()
    assert not line["correct"], checks
