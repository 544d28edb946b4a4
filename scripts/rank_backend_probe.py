#!/usr/bin/env python3
"""Which ``torch.distributed`` backend runs several ranks on ONE card.

    python3 scripts/rank_backend_probe.py [--ranks 2] [--mb 64] [--cases abc]
                                          [--nccl-env KEY=VALUE,...]

Spawns ``--ranks`` processes that all use ``cuda:0`` and, for each case,

  (a) NCCL with no extra environment;
  (b) NCCL with a distinct ``NCCL_HOSTID`` per rank and
      ``NCCL_SOCKET_IFNAME=lo``: NCCL takes the ranks for separate hosts
      and moves bytes over its socket transport;
  (c) gloo, on the same CUDA tensors;

runs ``all_gather_into_tensor``, ``all_reduce`` and a ``batch_isend_irecv``
ring on CUDA tensors of ``--mb`` MB per rank, first eagerly and then
inside a CUDA-graph capture (replayed once), and prints one JSON line per
case: what ran, whether each result was right, and GB/s (the bytes a rank
receives over the median of 3 timed calls, host clock to a synchronise).
``--nccl-env`` adds NCCL settings to case (b)'s environment (socket
threads, channels), to see what the socket transport can move.
A case that fails or hangs is reported and its processes killed; the
script never chooses a backend on its own. The last line is the card's
name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

CASE_TIMEOUT_S = 150
OPS = ("all_gather", "all_reduce", "ring")


def _env(case: str, rank: int, extra: dict | None = None) -> dict:
    if case == "b":
        return {"NCCL_HOSTID": f"rank-probe-host-{rank}", "NCCL_SOCKET_IFNAME": "lo",
                **(extra or {})}
    return {}


def _run_op(op: str, dist, torch, x, out, rank: int, n: int):
    if op == "all_gather":
        dist.all_gather_into_tensor(out, x)
    elif op == "all_reduce":
        out.copy_(x)
        dist.all_reduce(out)
    else:
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % n),
               dist.P2POp(dist.irecv, out, (rank - 1) % n)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _expected(op: str, torch, numel: int, rank: int, n: int, device):
    if op == "all_gather":
        return torch.cat([torch.full((numel,), float(r + 1), device=device) for r in range(n)])
    if op == "all_reduce":
        return torch.full((numel,), float(n * (n + 1) // 2), device=device)
    return torch.full((numel,), float((rank - 1) % n + 1), device=device)


def _worker(case: str, backend: str, rank: int, n: int, init: str, mb: int, extra: dict,
            queue) -> None:
    os.environ.update(_env(case, rank, extra))
    report = {"rank": rank}
    try:
        import datetime

        import torch
        import torch.distributed as dist

        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        tic = time.perf_counter()
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=60))
        report["init_s"] = time.perf_counter() - tic
        numel = mb * (1 << 20) // 4
        x = torch.full((numel,), float(rank + 1), device=device)
        for op in OPS:
            out = torch.empty((numel * n if op == "all_gather" else numel,), device=device)
            row = {}
            try:
                _run_op(op, dist, torch, x, out, rank, n)  # warm-up (communicator set-up)
                torch.cuda.synchronize()
                row["eager_ok"] = bool(torch.equal(out, _expected(op, torch, numel, rank, n,
                                                                  device)))
                times = []
                for _ in range(3):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _run_op(op, dist, torch, x, out, rank, n)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                recv = {"all_gather": (n - 1) * numel * 4, "all_reduce": numel * 4,
                        "ring": numel * 4}[op]
                row["ms"] = 1e3 * sorted(times)[1]
                row["gb_per_s"] = recv / sorted(times)[1] / 1e9
            except Exception as exc:  # report the failure of this op, go on to the next
                row["eager_error"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}"
            try:
                out.zero_()
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    _run_op(op, dist, torch, x, out, rank, n)
                out.zero_()
                graph.replay()
                torch.cuda.synchronize()
                row["captured_ok"] = bool(torch.equal(out, _expected(op, torch, numel, rank, n,
                                                                     device)))
                del graph
            except Exception as exc:
                row["capture_error"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}"
            report[op] = row
        dist.barrier()
        dist.destroy_process_group()
    except Exception as exc:
        report["error"] = f"{type(exc).__name__}: {exc}"[:600]
        report["trace"] = traceback.format_exc()[-1500:]
    queue.put(report)


def run_case(case: str, n: int, mb: int, extra: dict) -> dict:
    import multiprocessing as mp

    backend = "gloo" if case == "c" else "nccl"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        tic = time.perf_counter()
        procs = [ctx.Process(target=_worker, args=(case, backend, r, n, init, mb, extra, queue))
                 for r in range(n)]
        for p in procs:
            p.start()
        reports, deadline = [], time.monotonic() + CASE_TIMEOUT_S
        while len(reports) < n and time.monotonic() < deadline:
            try:
                reports.append(queue.get(timeout=5))
            except Exception:  # queue.Empty: keep waiting until the deadline
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        seconds = time.perf_counter() - tic
    hung = len(reports) < n
    env = {k: v for k, v in _env(case, 0, extra).items() if k != "NCCL_HOSTID"}
    return {"case": case, "backend": backend, "env": env, "ranks": n, "mb_per_rank": mb, "seconds": seconds,
            "hung_or_died": hung, "reports": sorted(reports, key=lambda r: r["rank"])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--mb", type=int, default=64)
    parser.add_argument("--cases", default="abc")
    parser.add_argument("--nccl-env", default="", help="KEY=VALUE,... added to case (b)")
    args = parser.parse_args(argv)
    extra = dict(kv.split("=", 1) for kv in args.nccl_env.split(",") if kv)
    import torch

    if not torch.cuda.is_available():
        print("rank_backend_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version()))}), flush=True)
    for case in args.cases:
        print(json.dumps(run_case(case, args.ranks, args.mb, extra)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
