"""The readings a cell's limits are set from: for each seed, the numbers
compared for the port and for the control (the reference in the next
precision down, in the port's place), and for a training cell the faults
planted in the reference in the port's place. One process, many seeds:

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 [--modes program,control]

Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import bench  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--modes", default="program,control")
    args = ap.parse_args(argv)
    import torch

    bm = bench.benchmark()
    workload, config, traffic = bench.cell(bm, args.workload)
    bench.require_cards(workload["chips"])
    driver = bench.load_module("drivers", config["driver"])
    modes = args.modes.split(",")
    print(f"# {torch.cuda.get_device_name(0)}; nvidia-smi: {bench.power_limit()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench.Context(workload=args.workload, seed=seed, seconds=0.0, trace=False,
                            device=torch.device("cuda", 0), config=config, traffic=traffic,
                            peaks=bench.peaks(), spans=bench.Spans())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **driver.calibrate(ctx, modes)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
