#!/usr/bin/env python3
"""Latency of one NCCL collective among four ranks sharing one card.

    python3 scripts/nccl_latency_probe.py

Spawns four rank processes on ``cuda:0`` with ``chip_smoke.py``'s rank
environment (a ``NCCL_HOSTID`` each, so NCCL moves bytes over its socket
transport on loopback) under a few host settings -- as is, one intra-op
thread a rank, one socket thread a rank, both, NCCL's LL protocol -- and
prints, per setting, the mean time of an eager ``all_reduce`` of 4 KiB
(100 of them) and of 4 MiB (10), each on the host clock around work that
ends in ``torch.cuda.synchronize()``, with the card's name and power limit.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

# name -> (extra NCCL environment, intra-op threads a rank or None)
VARIANTS = {
    "as_is": ({}, None),
    "threads1": ({}, 1),
    "socket1": ({"NCCL_SOCKET_NTHREADS": "1", "NCCL_NSOCKS_PERTHREAD": "1"}, None),
    "socket1_threads1": ({"NCCL_SOCKET_NTHREADS": "1", "NCCL_NSOCKS_PERTHREAD": "1"}, 1),
    "ll_threads1": ({"NCCL_PROTO": "LL"}, 1),
}


def _mean_ms(x: torch.Tensor, n: int) -> float:
    import torch.distributed as dist

    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - tic) / n


def job(rank: int, n: int, init: str, args: dict, device: torch.device, queue) -> None:
    import torch.distributed as dist

    env, threads = VARIANTS[args["variant"]]
    os.environ.update(C.rank_env(rank))
    os.environ.update(env)
    if threads:
        torch.set_num_threads(threads)
    try:
        device = C.join_ranks(rank, n, init, device)
        small = torch.ones(1024, device=device)
        _mean_ms(small, 20)  # warm-up: the communicators' first use
        out = {"small_4KiB_ms": _mean_ms(small, 100),
               "big_4MiB_ms": _mean_ms(torch.ones(1 << 20, device=device), 10)}
        queue.put((rank, out, None))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        import traceback

        queue.put((rank, None, traceback.format_exc()))


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_latency_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = C.card()
    for name in VARIANTS:
        rows, wall = C.spawn_ranks(job, 4, {"variant": name}, torch.device("cuda"), 120, name)
        print(f"{name} {json.dumps({'wall_s': wall, 'ranks': rows})} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
