"""The simulator cells on the CPU at a size a test run holds: the plain
references against the port, a whole run of the harness past its look for
a card, the control, and the faults a step can have, each of which has to
make ``correct`` come out false."""

from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

from perfbench import bench, run
from perfbench.drivers import sim as sim_driver
from perfbench.gen import blobs
from perfbench.reference import stlfw

CELLS = ("sim.mnist-linear.n100-d10",)
CPU = torch.device("cpu")


def _small(workload: str) -> tuple[dict, dict]:
    """The cell's configuration and traffic at a test's size: 8 nodes,
    budget 3, calls of 300 steps evaluated every 100, the cell's limits."""
    _, cfg, tr = bench.cell(bench.benchmark(), workload)
    cfg = dict(cfg, data=dict(cfg["data"], n_samples=5000, n_test=1000))
    tr = dict(tr, n_nodes=8, budget=3, steps_per_call=300, eval_every=100, pool_spare_steps=16)
    return cfg, tr


def _measure(workload: str, seed: int = 2**31 + 11) -> tuple[dict, list]:
    cfg, tr = _small(workload)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0.2, trace=0)
    return run.measure(args, CPU, config=cfg, traffic=tr)


@pytest.mark.parametrize("n,budget,seed", [(8, 3, 5), (100, 10, 2), (64, 16, 3)])
def test_reference_stlfw_picks_the_ports_atoms(n, budget, seed):
    from repro_torch.core.stl_fw import learn_topology

    y = np.random.default_rng(seed).integers(0, 10, size=60 * n).astype(np.int32)
    _, Pi = blobs.shard_partition(y, n, 2, seed, 10)
    port = learn_topology(Pi, budget, lam=0.1)
    coeffs, perms, W = stlfw.learn(Pi, budget, 0.1)
    assert [list(p) for p in perms] == [list(p) for p in port.perms]
    np.testing.assert_array_equal(np.asarray(coeffs), port.coeffs)
    np.testing.assert_array_equal(W, port.W)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    line, checks = _measure(workload)
    assert line["correct"], checks
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"sim_steps_per_s", "setup_s"}
    assert all(value <= limit / 10 for _, value, limit in checks), checks


@pytest.mark.parametrize("mode", ["control", "fault:no_mix", "fault:unchanged",
                                  "fault:half_batch", "fault:alter"])
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, mode):
    """The reference in TF32, or with a fault planted, in the port's place
    fails a limit."""
    cfg, tr = _small(workload)
    ctx = bench.Context(workload, 2**31 + 5, 0.0, False, CPU, cfg, tr, bench.peaks(),
                        bench.Spans())
    numbers = sim_driver.calibrate(ctx, [mode])[mode]
    assert not all(v <= lim for _, v, lim in bench.gap_checks(numbers, tr["limits"])), numbers


def _no_mix(params, grads, state, W, lr, *args, **kwargs):
    return {k: params[k] - lr * grads[k] for k in params}, state


def _unchanged(params, grads, state, *args, **kwargs):
    return params, state


FAULTS = {
    "unchanged": ("dsgd_step_stacked", lambda orig: _unchanged),
    "no_mix": ("dsgd_step_stacked", lambda orig: _no_mix),
    "half_batch": ("classifier_losses",
                   lambda orig: lambda logits, y: orig(logits[:, : y.shape[1] // 2],
                                                       y[:, : y.shape[1] // 2])),
    "alter": ("classifier_losses", lambda orig: lambda logits, y: orig(logits, y) + 1e-2),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    from repro_torch.train import trainer

    name, make = FAULTS[fault]
    monkeypatch.setattr(trainer, name, make(getattr(trainer, name)))
    line, checks = _measure(workload)
    assert not line["correct"], checks
