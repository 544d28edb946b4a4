"""The readers of the port's spans (``port_spans.py`` and the
``layer_metrics`` that use it): hand-worked values on a hand-built trace,
nothing where the port recorded no such span, and a traced run of the
simulator cell on the CPU that reports them all."""

from __future__ import annotations

import argparse

import pytest
import torch

from perfbench import bench, port_spans, run
from perfbench.tests.test_perfbench_sim import _small

CELL = "sim.mnist-linear.n100-d10"
SPAN_METRICS = ("prepare_s.sim", "capture_s.sim", "eval_s.sim", "release_s.sim",
                "idle_host_work.sim")


def _trace() -> bench.Trace:
    """A window of 1,000 ns. Device operations straddle both of its edges
    and the capture span's end; ``sim.prepare`` and ``sim.release`` reach
    past the window, one ``sim.eval`` lies outside it."""
    return bench.Trace(
        device=[("k0", -100, 20), ("k1", 50, 150), ("k2", 400, 500), ("k3", 900, 1100)],
        host=[("bench.traced", 0, 1000), ("sim.prepare", -50, 200), ("sim.segment", 200, 600),
              ("graph.warmup", 250, 300), ("graph.capture", 350, 450),
              ("aten::copy_", 360, 370), ("sim.eval", 600, 700), ("sim.release", 950, 1200),
              ("sim.eval", 1300, 1400)],
        window=(0, 1000))


def _read(name: str, trace) -> float | None:
    out = bench.Outcome(attempted=1, failed=0, end_to_end={}, layer={}, checks=[],
                        memory_peak_bytes=0, window_start=0.0, trace=trace)
    return bench.load_module("layer_metrics", name).read(out, None)


@pytest.mark.parametrize("name,worked", [
    ("prepare_s.sim", 200e-9),  # (0, 200): clipped at the window's start
    ("capture_s.sim", 150e-9),  # 50 + 100
    ("eval_s.sim", 100e-9),  # the evaluation after the window is left out
    ("release_s.sim", 50e-9),  # (950, 1000): clipped at the window's end
    # idle inside (0,200) 200-20-100, (250,300) 50, (350,450) 100-50,
    # (600,700) 100, (950,1000) 0: 280 of 1,000 ns
    ("idle_host_work.sim", 28.0),
    ("idle_share.sim", 68.0),  # busy 20 + 100 + 100 + 100 of 1,000 ns
])
def test_span_readers_match_hand_worked_values(name, worked):
    assert _read(name, _trace()) == pytest.approx(worked, rel=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_without_the_ports_spans_reads_nothing(name):
    """The parent's trace has only the harness's spans: no number, no error."""
    trace = bench.Trace(device=[("k1", 50, 150)], host=[("bench.traced", 0, 1000)],
                        window=(0, 1000))
    assert _read(name, trace) is None
    assert _read(name, None) is None


def test_union_merges_overlapping_and_touching_intervals():
    assert port_spans.union([(10, 12), (3, 8), (0, 5), (8, 9)]) == [(0, 9), (10, 12)]
    assert port_spans.union([]) == []


def test_idle_inside_nested_spans_counts_once():
    trace = bench.Trace(device=[("k", 40, 60)],
                        host=[("sim.segment", 0, 100), ("graph.warmup", 10, 90),
                              ("graph.capture", 20, 50), ("sim.eval", 80, 120)],
                        window=(0, 100))
    # union of the host work (10, 100): 90 ns, of which the device ran 20
    assert port_spans.idle_inside_s(trace, port_spans.HOST_WORK) == pytest.approx(70e-9)
    assert port_spans.summed_s(trace, ("sim.segment",)) == pytest.approx(100e-9)


def test_a_traced_cpu_run_reports_the_span_metrics():
    cfg, tr = _small(CELL)
    args = argparse.Namespace(workload=CELL, seed=2**31 + 17, seconds=0.2, trace=1)
    line, checks = run.measure(args, torch.device("cpu"), config=cfg, traffic=tr)
    assert line["correct"], checks
    metrics = {name: m["value"] for name, m in line["metrics"].items()}
    assert set(SPAN_METRICS) <= set(metrics), sorted(metrics)
    assert all(metrics[name] > 0 for name in SPAN_METRICS), metrics
    assert metrics["idle_host_work.sim"] <= metrics["idle_share.sim"]
    assert metrics["rollout_ms_per_step.sim"] > 0 and metrics["captures.sim"] == 2
