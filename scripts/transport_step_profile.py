#!/usr/bin/env python3
"""Device time of phase 2b's D-SGD step by kernel, schedule against dense
transport, on one NVIDIA GPU.

    python3 scripts/transport_step_profile.py [--top K]

Runs ``chip_smoke.py``'s phase 2b -- the MNIST-width MLP on n = 100 nodes
with the STL-FW topology of budget 10, 256 steps under the captured
rollout (``rollout="scan"``), no evaluation -- once with the Birkhoff
schedule (``gossip_schedule`` after the ravel copy) and once with its
dense W (``gossip_mix`` a leaf), each under ``torch.profiler``, twice in
the order schedule, dense, schedule, dense. Prints each run's device ms
per step (host-to-device copies left out) and device operations per
step, and for the first run of each arm its ``--top`` kernels in device
us per step.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STEPS = 256


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("transport_step_profile: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.build_all()
    X, y, idx, Pi = cs.mnist_width_data()
    n_train = sum(len(i) for i in idx)
    res = cs.learn_topology(Pi, budget=10, lam=0.1)
    sched = cs.schedule_from_result(res)
    print(f"n {sched.n_nodes}, atoms {sched.n_atoms} ({sched.n_communication_atoms} communicate)")
    arms = {"schedule": (None, sched), "dense": (res.W, None)}
    kw = dict(model="mlp", hidden=64, batch_size=64, lr=0.2, seed=0, device="cuda",
              steps=STEPS, eval_every=32, X_test=None, y_test=None, rollout="scan")
    for rep in range(2):
        for arm, (W, schedule) in arms.items():
            per_kernel, n_ops = cs.device_profile(cs.run_classification, X[:n_train],
                                                  y[:n_train], idx, W, schedule=schedule, **kw)
            steps = {k: v for k, v in per_kernel.items() if "HtoD" not in k}
            print(f"{arm} run {rep}: device ms/step {sum(steps.values()) / STEPS:.5f}, "
                  f"ops/step {n_ops / STEPS:.2f}", flush=True)
            if rep == 0:
                for name, ms in sorted(steps.items(), key=lambda kv: -kv[1])[:args.top]:
                    print(f"    {1e3 * ms / STEPS:8.2f} us  {name[:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
