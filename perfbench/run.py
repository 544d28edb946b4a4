"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. ``BENCHMARK.json`` names the cell's configuration and traffic;
the configuration file names the driver (``drivers/<driver>.py``) that
sets up, warms up, measures ``--seconds`` seconds and checks what the
timed path produced against a plain reference. With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, each read by ``layer_metrics/<name>.py``, and the
device's busy and idle time from the profiler's trace.

The last line of standard output is the result (JSON); the lines before
it describe the card and what the cell resolved to; the last lines of
standard error give each number compared beside its limit. Without the
cards the cell needs, the run exits non-zero and prints no result; so it
does if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # setup_s runs from here to the window's start

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import bench  # noqa: E402

# every build and kernel cache at a fixed place inside the checkout
CACHES = {
    "TRITON_CACHE_DIR": "build/perfbench/triton",
    "TORCHINDUCTOR_CACHE_DIR": "build/perfbench/inductor",
    "TORCH_EXTENSIONS_DIR": "build/perfbench/torch_extensions",
}


def parse(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args: argparse.Namespace, device, *, config: dict | None = None,
            traffic: dict | None = None, root: Path = bench.ROOT) -> tuple[dict, list]:
    """Run the cell on ``device`` and return the result line and the checks
    (the tests drive this on the CPU, at sizes of their own)."""
    import torch

    bm = bench.benchmark(root)
    workload, cfg_file, traffic_file = bench.cell(bm, args.workload, root)
    ctx = bench.Context(
        workload=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, config=config or cfg_file, traffic=traffic or traffic_file,
        peaks=bench.peaks(root), spans=bench.Spans(),
        say=lambda line: print(line, flush=True))
    driver = bench.load_module("drivers", ctx.config["driver"], root)
    out = driver.run(ctx)
    setup_s = out.window_start - T0
    metrics = {}
    if not args.trace:
        for m in bench.cell_metrics(bm, args.workload, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else out.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in bench.cell_metrics(bm, args.workload, "per_layer"):
            value = bench.load_module("layer_metrics", m["name"], root).read(out, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": workload["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if args.trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_ops(), "idle_gaps": out.trace.idle_gaps()}
    return line, out.checks


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    import torch

    workload = bench.entry(bench.benchmark()["workloads"], args.workload, "workload")
    bench.require_cards(workload["chips"])
    print(f"# device {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible, "
          f"{workload['chips']} used; nvidia-smi: {bench.power_limit()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    line, checks = measure(args, torch.device("cuda", 0))
    found = bench.forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    if args.trace and "busy_s" not in line["device"]:
        print("perfbench: the traced run recorded no device window", file=sys.stderr)
        return 4
    bench.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
