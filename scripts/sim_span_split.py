"""Where a simulator call's device-idle time sits, by the port's own spans,
and what an enabled tracer and the profiler cost a call.

    python3 scripts/sim_span_split.py --seeds 3400000011,3400000013 [--calls 3]
    python3 scripts/sim_span_split.py --seeds 5 --small    # on the CPU, at a test's size

For each seed, in one process: the benchmark cell ``sim.mnist-linear.n100-d10``
set up as ``perfbench/drivers/sim.py`` sets it up (data, topology, the
two-period warm-up call); then ``--calls`` calls with ``tracer=None`` and
as many with a ``Tracer()``, alternating, with no profiler; then one call
under ``torch.profiler`` inside a ``bench.traced`` range, as the
benchmark's traced run makes it. One JSON line a seed gives the calls'
seconds, the traced call's device-idle seconds inside each kind of port
span -- ``sim.prepare``, ``graph.warmup``, ``graph.capture``,
``sim.eval``, ``sim.release`` and the replay part of ``sim.segment``
(outside its warm-ups and captures) -- and outside all of them, every
``cudaFree`` / ``cudaMalloc`` / ``cudaGraphExecDestroy`` host call over
1 ms with the innermost port span it ran in, the ten longest idle gaps
named so, and what the five span metrics and ``idle_share.sim`` read.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import bench, port_spans  # noqa: E402

CELL = "sim.mnist-linear.n100-d10"
PORT = ("sim.prepare", "sim.segment", "sim.eval", "sim.release", "graph.warmup",
        "graph.capture")
METRICS = ("prepare_s.sim", "capture_s.sim", "eval_s.sim", "release_s.sim",
           "idle_host_work.sim", "idle_share.sim")
DRIVER_CALLS = ("cudaFree", "cudaMalloc", "cudaGraphExecDestroy")


def _innermost(trace: bench.Trace, t: int) -> str:
    open_ = [(b - a, n) for n, a, b in trace.host if n in PORT and a <= t <= b]
    return min(open_)[1] if open_ else "outside"


def split(trace: bench.Trace) -> dict:
    """Device-idle seconds of the traced call by the innermost port span."""
    idle = trace.window_s - trace.busy_s()
    parts = {name: port_spans.idle_inside_s(trace, (name,)) or 0.0
             for name in ("sim.prepare", "graph.warmup", "graph.capture", "sim.eval",
                          "sim.release")}
    graphs = port_spans.idle_inside_s(trace, ("graph.warmup", "graph.capture")) or 0.0
    segments = port_spans.idle_inside_s(trace, ("sim.segment",)) or 0.0
    parts["sim.segment replays"] = segments - graphs
    parts["outside"] = idle - sum(parts.values())
    frees = [[n, (b - a) / 1e9, _innermost(trace, (a + b) // 2)] for n, a, b in trace.host
             if n in DRIVER_CALLS and b - a > 1_000_000]
    gaps = []
    lo, hi = trace.window
    end = lo
    for a, b in port_spans.union((a, b) for _, a, b in trace.clipped()) + [(hi, hi)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]  # named after the cut: O(events) each
    return {"window_s": trace.window_s, "idle_s": idle, "split_s": parts,
            "accounted": 1.0 - parts["outside"] / idle if idle > 0 else None,
            "driver_calls": sorted(frees, key=lambda f: -f[1]),
            "gaps": [[_innermost(trace, (a + b) // 2), (b - a) / 1e9] for a, b in gaps]}


def one_seed(seed: int, calls: int, device, small: bool) -> dict:
    import torch

    from repro_torch.obs.trace import Tracer

    bm = bench.benchmark()
    _, config, traffic = bench.cell(bm, CELL)
    if small:  # perfbench/tests/test_perfbench_sim.py's sizes
        config = dict(config, data=dict(config["data"], n_samples=5000, n_test=1000))
        traffic = dict(traffic, n_nodes=8, budget=3, steps_per_call=300, eval_every=100,
                       pool_spare_steps=16)
    ctx = bench.Context(CELL, seed, 0.0, True, device, config, traffic, bench.peaks(),
                        bench.Spans())
    driver = bench.load_module("drivers", config["driver"])
    driver.precision.no_tf32()
    sim = driver.Sim(ctx)
    sim.call(0, steps=min(sim.steps, 2 * traffic["eval_every"]))
    bench.sync(device)
    with torch.profiler.profile(activities=bench.profiler_activities(device)):
        torch.ones(1, device=device).add_(1)

    def timed(c: int, tracer) -> float:
        t0 = time.perf_counter()
        sim.call(c, tracer)
        bench.sync(device)
        return time.perf_counter() - t0

    seconds: dict[str, list[float]] = {"none": [], "tracer": []}
    c = 1
    for i in range(2 * calls):  # none, tracer, tracer, none, ...
        kind = "none" if i % 4 in (0, 3) else "tracer"
        seconds[kind].append(timed(c, Tracer() if kind == "tracer" else None))
        c += 1
    spans = bench.Spans()
    spans.profiling = True
    with torch.profiler.profile(activities=bench.profiler_activities(device)) as prof:
        with spans.span("bench.traced"):
            sim.call(c, Tracer())
            bench.sync(device)
    trace = bench.read_trace(prof, "bench.traced")
    del prof
    out = bench.Outcome(attempted=1, failed=0, end_to_end={}, layer={}, checks=[],
                        memory_peak_bytes=0, window_start=0.0, trace=trace)
    metrics = {m: bench.load_module("layer_metrics", m).read(out, ctx) for m in METRICS}
    return {"seed": seed, "calls_s": seconds,
            "median_s": {k: statistics.median(v) for k, v in seconds.items()},
            "traced_call_s": spans.records[-1].seconds, "metrics": metrics, **split(trace)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--calls", type=int, default=3, help="calls of each kind, no profiler")
    ap.add_argument("--small", action="store_true", help="a test's sizes, on the CPU")
    args = ap.parse_args(argv)
    import torch

    if args.small:
        device = torch.device("cpu")
    else:
        bench.require_cards(1)
        device = torch.device("cuda", 0)
        print(f"# {torch.cuda.get_device_name(0)}; nvidia-smi: {bench.power_limit()}; "
              f"torch {torch.__version__}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(one_seed(seed, args.calls, device, args.small)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
