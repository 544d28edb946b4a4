"""The LM training cell with one D-SGD node a rank: the port's trainer
(``repro_torch.train.lm_trainer.make_train_setup(cfg, group=...)``: a node
a rank of a ``torch.distributed`` group, the gossip its collectives) on n
cards over NCCL, driven through ``TrainSetup.multi_step_fn("scan")`` in
segments of captured steps, as ``lm_train.py`` drives n stacked nodes on
one card. It takes ``lm_train.py``'s inputs, reference, comparison and
limits and edits none of them.

This process is rank 0, on the card it is given; it starts ranks 1 to
n-1 itself (``python -m perfbench.drivers.lm_train_ranks``, each on card
``cuda:<rank>``), which join it at ``tcp://localhost:<a free port>``. Every
rank makes the seed's weights and the pool of batches (``gen/``: the same
draws on every card) and keeps its own node's row. Set-up, warm-up and the
checked segment are ``lm_train.py``'s on each rank; the window runs
segment after segment on every rank in step, rank 0 broadcasting after
each whether the window has closed. Rank 0 reports: its window's time,
every rank's peak memory, and the tokens of all n nodes.

Correctness: each rank's checked replay gives its losses (the step's loss
is the mean over the ranks), its node's gradient norms at the segment's
last step and its node's change norms; over the ranks these make the
stacked norms ``lm_train.compare`` reads (the square root of the sum of
the squares), held to ``reference/qwen3_dsgd.py``'s readings of the same
steps, computed on rank 0's card once every rank has freed its state.

On a CPU (the tests) the ranks join over gloo, which cannot capture its
collectives: there the multi-step function is ``"loop"``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from perfbench.bench import Context, Outcome, gap_checks, profiler_activities, read_trace
from perfbench.counts import qwen3
from perfbench.drivers import lm_train
from perfbench.gen import tokens, weights

JOIN_S = 300  # a rank's limit to join the group, and the parent's to wait for the ranks


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def node(rank: int, n: int, port: int, config: dict, traffic: dict, seed: int, seconds: float,
         trace: bool) -> dict | None:
    """One rank's part of the run; rank 0 returns every rank's numbers
    (and its trace), the others None."""
    import torch.distributed as dist

    from repro_torch.core.mixing import schedule_from_result
    from repro_torch.core.stl_fw import learn_topology
    from repro_torch.train.lm_trainer import make_train_setup

    cuda = torch.cuda.is_available() and torch.cuda.device_count() >= n
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n, timeout=datetime.timedelta(seconds=JOIN_S))
    tr, seg = traffic, traffic["segment_steps"]
    result = learn_topology(lm_train.pi(tr), tr["budget"])
    schedule = schedule_from_result(result)
    setup = make_train_setup(lm_train.model_config(config), group=dist.group.WORLD,
                             schedule=schedule, lr=config["lr"], momentum=config["momentum"],
                             device=dev)
    multi = setup.multi_step_fn("scan" if cuda else "loop")
    params0 = {k: v[0] for k, v in weights.make(config, 1, seed, dev,
                                                getattr(torch, config["torch_dtype"])).items()}
    probs = tokens.domain_probs(config["vocab_size"], n, tr["zipf_a"], seed)
    pool = tokens.batches(probs, lm_train.pi(tr), tr["pool_steps"], tr["per_node_batch"],
                          tr["seq_len"], dev, seed)
    pool = {k: v[:, rank].contiguous() for k, v in pool.items()}

    p, o = params0, None
    for at in (seg, 2 * seg):  # the body's eager run, then its capture and first replay
        p, o, lo = multi(p, o, lm_train._slice(pool, at, seg))
        lo.cpu()
    captures = multi.n_traces
    p, o, lo = multi(params0, None, lm_train._slice(pool, 0, seg))
    if multi.n_traces != captures:
        raise RuntimeError("the checked segment captured its body again")
    got = {"losses": [float(v) for v in lo.cpu()],
           "grad_sq": {k: float(g.float().square().sum()) for k, g in multi.grads.items()},
           "change_sq": {k: float((p[k].float() - params0[k].float()).square().sum())
                         for k in params0}}
    del params0
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if trace and rank == 0:  # the profiler's own start-up stays out of the traced segment
        with torch.profiler.profile(activities=profiler_activities(dev)):
            torch.ones(1, device=dev).add_(1)
    dist.barrier()
    stop = torch.zeros(1, device=dev)
    at, segments = 3 * seg, 0
    t0 = time.perf_counter()
    while True:
        p, o, lo = multi(p, o, lm_train._slice(pool, at, seg))
        lo.cpu()
        at += seg
        segments += 1
        if rank == 0:
            stop.fill_(float(time.perf_counter() - t0 >= seconds))
        dist.broadcast(stop, 0)
        if float(stop) > 0:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace_out = None
    if trace:
        if rank == 0:
            with torch.profiler.profile(activities=profiler_activities(dev)) as prof:
                with torch.profiler.record_function("bench.traced"):
                    p, o, lo = multi(p, o, lm_train._slice(pool, at, seg))
                    lo.cpu()
            trace_out = read_trace(prof, "bench.traced")
            del prof
        else:
            p, o, lo = multi(p, o, lm_train._slice(pool, at, seg))
            lo.cpu()
    mine = {"rank": rank, "got": got, "segments": segments, "window_s": window_s, "peak": peak,
            "captures": multi.n_traces, "lmo": result.lmo_backend, "t0": t0}
    everyone = [None] * n if rank == 0 else None
    dist.gather_object(mine, everyone, dst=0)
    del multi, setup, p, o, pool
    dist.barrier()  # every rank's state is freed before rank 0's reference
    dist.destroy_process_group()
    if rank != 0:
        return None
    return {"ranks": everyone, "trace": trace_out}


def combine(ranks: list[dict]) -> dict:
    """The stacked readings of the ranks' own: the losses (already the mean
    over ranks), the norms over all nodes."""
    keys = ranks[0]["got"]["grad_sq"]
    return {"losses": ranks[0]["got"]["losses"],
            "grad_norms": {k: float(np.sqrt(sum(r["got"]["grad_sq"][k] for r in ranks)))
                           for k in keys},
            "change_norms": {k: float(np.sqrt(sum(r["got"]["change_sq"][k] for r in ranks)))
                             for k in keys}}


def run(ctx: Context) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, seg = tr["n_nodes"], tr["segment_steps"]
    port = _free_port()
    args = [json.dumps(cfg), json.dumps(tr), str(ctx.seed), str(ctx.seconds), str(int(ctx.trace))]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    with ctx.spans.span("bench.setup.ranks"):
        others = [subprocess.Popen([sys.executable, "-m", "perfbench.drivers.lm_train_ranks",
                                    str(rank), str(n), str(port), *args], env=env)
                  for rank in range(1, n)]
    try:
        out = node(0, n, port, cfg, tr, ctx.seed, ctx.seconds, ctx.trace)
    finally:
        for proc in others:
            try:
                proc.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                proc.kill()
    if any(proc.returncode for proc in others):
        raise RuntimeError(f"ranks exited {[proc.returncode for proc in others]}")
    ranks = out["ranks"]
    ctx.say(f"# {n} ranks, one node a rank ({'nccl' if dev.type == 'cuda' else 'gloo'}); lmo "
            f"{ranks[0]['lmo']}; segments {[r['segments'] for r in ranks]}; peaks "
            f"{[r['peak'] for r in ranks]} bytes")
    window_s = ranks[0]["window_s"]
    tokens_done = ranks[0]["segments"] * seg * n * tr["per_node_batch"] * tr["seq_len"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = gap_checks(lm_train.compare(combine(ranks), lm_train.reference(ctx)), tr["limits"])
    peak = max(r["peak"] for r in ranks)
    return Outcome(
        attempted=ranks[0]["segments"], failed=0,
        end_to_end={"train_tokens_per_s": tokens_done / window_s, "train_peak_gib": peak / 2 ** 30},
        layer={"captures_train": ranks[0]["captures"],
               "model_flops_per_s": qwen3.train_flops_per_token(cfg, tr["seq_len"])
               * tokens_done / window_s / n, "mfu_peak": "bf16_flops_per_s"},
        checks=checks, memory_peak_bytes=int(peak), window_start=ranks[0]["t0"],
        trace=out["trace"])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="one rank (1 to n-1) of the ranks cell")
    for name in ("rank", "n", "port", "config", "traffic", "seed", "seconds", "trace"):
        ap.add_argument(name)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    node(int(a.rank), int(a.n), int(a.port), json.loads(a.config), json.loads(a.traffic),
         int(a.seed), float(a.seconds), bool(int(a.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
