"""The port's spans on the profiler's clock (``repro_torch/obs/trace.py``).

A simulator call (``run_classification``) names its phases -- staging,
each body's warm-up and capture, segments, evaluations, release -- as
``record_function`` ranges while a profiler records, with or without a
tracer, and records the same spans in an enabled tracer's ring. With no
profiler recording, no range is opened. The ring keeps the reference
tracer's records (``repro/obs/trace.py``), of which the port's began as a
copy.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.obs.trace import Tracer as RefTracer  # noqa: E402

from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import cluster_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs  # noqa: E402
from repro_torch.graphs import Body, GraphRunner  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.train import rollout as T_roll  # noqa: E402
from repro_torch.train import trainer as T_tr  # noqa: E402

PORT_SPANS = ("sim.prepare", "sim.segment", "graph.warmup", "graph.capture", "sim.eval",
              "sim.release")
CPU = [torch.profiler.ProfilerActivity.CPU]


def _problem():
    """8 nodes, 300 steps of batch 8, an evaluation every 100 steps."""
    X, y = gaussian_blobs(n_samples=600, num_classes=4, dim=8, seed=0)
    idx, Pi = cluster_partition(y[:500], 8)
    W = learn_topology(Pi, budget=3, lam=0.1).W
    kw = dict(steps=300, batch_size=8, eval_every=100, X_test=X[500:], y_test=y[500:],
              device="cpu", seed=1)
    return (X[:500], y[:500], idx, W), kw


def _profiled_call(tracer):
    """The call inside an outer range ``call``, under the profiler: the
    log and the host ranges, (name, start, end)."""
    args, kw = _problem()
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.profiler.record_function("call"):
            log = T_tr.run_classification(*args, tracer=tracer, **kw)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return log, [r for r in ranges if r[0] in PORT_SPANS + ("call",)]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _check_ranges(log, ranges):
    counts = Counter(name for name, _, _ in ranges)
    evals = sum("acc_mean" in row for row in log.history)
    assert counts["call"] == 1 and counts["sim.prepare"] == counts["sim.release"] == 1
    assert counts["graph.capture"] == log.aux["n_traces"] == 2
    assert counts["sim.segment"] == evals == counts["sim.eval"] == 4
    assert counts["graph.warmup"] == 4  # a body a shape: 1, 64, 36 and 35 steps
    call = next(r for r in ranges if r[0] == "call")
    assert all(_inside(r, call) for r in ranges)
    segments = [r for r in ranges if r[0] == "sim.segment"]
    graphs = [r for r in ranges if r[0].startswith("graph.")]
    assert all(any(_inside(g, s) for s in segments) for g in graphs)
    # no port range opens inside a body's run
    assert not any(_inside(r, g) for g in graphs for r in ranges if r is not g)
    return counts


def test_a_traced_call_names_its_phases_under_the_profiler():
    tracer = Tracer()
    log, ranges = _profiled_call(tracer)
    counts = _check_ranges(log, ranges)
    recorded = Counter(sp.name for sp in tracer.spans())
    assert recorded == Counter({name: counts[name] for name in PORT_SPANS})
    warm = tracer.spans("graph.warmup")
    assert {sp.attrs["runner"] for sp in warm} == {"classification.roll"}
    assert all(sp.parent == "sim.segment" for sp in warm + tracer.spans("graph.capture"))
    assert [sp.attrs["t"] for sp in tracer.spans("sim.eval")] == [0, 100, 200, 299]
    # what the call computes does not change under the profiler and a tracer
    args, kw = _problem()
    plain = T_tr.run_classification(*args, **kw)
    assert plain.history == log.history


def test_a_call_without_a_tracer_still_names_its_ranges():
    log, ranges = _profiled_call(None)
    _check_ranges(log, ranges)
    assert T_tr._NULL_TRACER.spans() == []


def test_no_range_opens_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracer = Tracer()
    args, kw = _problem()
    log = T_tr.run_classification(*args, tracer=tracer, **kw)
    recorded = Counter(sp.name for sp in tracer.spans())
    assert recorded["graph.capture"] == log.aux["n_traces"]
    assert recorded["sim.prepare"] == recorded["sim.release"] == 1
    assert recorded["sim.eval"] == recorded["sim.segment"] == 4


@pytest.mark.parametrize("enabled", [True, False])
def test_a_span_is_a_profiler_range_while_one_records(enabled):
    tracer = Tracer(enabled=enabled)
    with torch.profiler.profile(activities=CPU) as prof:
        with tracer.span("outer", k=1):
            with pytest.raises(ValueError):
                with tracer.span("inner"):
                    raise ValueError("inside")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("outer") == names.count("inner") == 1
    if enabled:
        inner, outer = tracer.spans()
        assert inner.parent == "outer" and "ValueError" in inner.attrs["error"]
        assert outer.attrs == {"k": 1}
    else:
        assert tracer.spans() == []


def test_the_graph_runner_spans_a_bodys_first_two_runs():
    tracer = Tracer()
    runner = GraphRunner("unit", torch.device("cpu"), tracer=tracer)
    out = torch.zeros(())
    body = Body(lambda: out.add_(1))
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(4):
            runner.run(body, "the unit body")
    assert out.item() == 4 and runner.n_traces == 1
    assert [(sp.name, sp.attrs) for sp in tracer.spans()] == [
        ("graph.warmup", {"runner": "unit", "what": "the unit body"}),
        ("graph.capture", {"runner": "unit", "what": "the unit body"})]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("graph.warmup") == names.count("graph.capture") == 1


def test_release_drops_the_bodies_and_keeps_the_count():
    runner = T_roll.SegmentRunner("unit.roll", torch.device("cpu"), captured=True)
    acc = runner.carry("acc", torch.zeros(()))

    def make_body(k, schedule):
        out = torch.zeros((k,))

        def body():
            for j in range(k):
                acc.add_(1)
                out[j] = acc

        return body, None, out

    fill = lambda inputs, t, k: None  # noqa: E731
    for t0 in (0, 64, 128):
        runner.run_segment(t0, 64, None, make_body, fill)
    assert runner.n_traces == 1 and len(runner._bodies) == 1
    runner.release()
    assert runner._bodies == {} and runner.n_traces == 1
    out = runner.run_segment(192, 64, None, make_body, fill)
    assert out[-1].item() == 256 and runner.n_traces == 1  # warmed up anew, not captured


def _drive(tracer):
    """Nested spans, instants and an evicting ring, on any tracer."""
    with tracer.span("seg", t0=0, k=4):
        tracer.instant("mark", t=2)
        with tracer.span("inner"):
            pass
    for i in range(5):
        with tracer.span("s", i=i):
            pass
    with pytest.raises(KeyError):
        with tracer.span("bad"):
            raise KeyError("x")
    return [(r.name, r.depth, r.parent, r.attrs, r.t0 == r.t1) for r in tracer.spans()]


@pytest.mark.parametrize("capacity", [3, 4096])
def test_the_ring_keeps_the_reference_tracers_records(capacity):
    port, ref = Tracer(capacity=capacity), RefTracer(capacity=capacity)
    assert _drive(port) == _drive(ref)
    assert port.dropped == ref.dropped
    summary = lambda tr: {k: v["count"] for k, v in tr.summary()["by_name"].items()}  # noqa: E731
    assert summary(port) == summary(ref)
    assert port.summary()["recorded"] == ref.summary()["recorded"]
    assert np.isclose(port.total_s("s"), sum(r.duration_s for r in port.spans("s")))
