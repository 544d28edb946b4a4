"""End-to-end D-SGD training of any architecture (the reference's
``repro/launch/train.py``):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-0.6b --steps 50 --topology stl-fw --budget 3

Run as one process, it trains ``--data`` nodes stacked on one card
(``make_train_setup(cfg, n_nodes=data)``; ``--device cpu`` runs the plain
path on the CPU). Under ``torchrun`` with ``data * model`` ranks
(``torchrun --nproc-per-node 8 -m repro_torch.launch.train --data 4
--model 2``) each rank joins the group (NCCL on cards, ``cuda:<local
rank>``; gloo with ``--device cpu``) and trains on the ``(data, model)``
mesh (``make_train_setup(cfg, mesh=make_host_mesh(data, model))``: a
node a ``data`` coordinate, its replica split over ``model``). The smoke
config by default, ``--full`` the full one. The learned STL-FW topology
comes from the data pipeline's per-node domain mixtures -- the paper's
pre-processing step -- and mixes as its Birkhoff schedule. A step's
batch is ``TokenBatcher.next_batch``'s, its nodes drawn in threads (each
node's draw has a generator of its own, and numpy samples without the
GIL: at qwen3's 151,936 tokens a node's Gumbel draws take seconds).
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import learn_topology, schedule_from_result
from repro_torch.core import topology as topo
from repro_torch.core.mixing import schedule_from_matrix
from repro_torch.data.tokens import DomainSkewCorpus, TokenBatcher
from repro_torch.models.common import dtype_of
from repro_torch.train.lm_trainer import make_train_setup
from repro_torch.train.metrics import MetricLogger

from .mesh import make_host_mesh

__all__ = ["build_topology", "next_batch", "main"]


def build_topology(kind: str, Pi: np.ndarray, budget: int, lam: float, device=None):
    """The mixing schedule of ``kind`` for the nodes' mixtures ``Pi`` (None:
    the complete graph, mixed by a mean)."""
    n = Pi.shape[0]
    if kind == "complete":
        return None
    if kind == "ring":
        return schedule_from_matrix(topo.ring(n))
    if kind == "random":
        return schedule_from_matrix(topo.random_d_regular(n, min(budget, n - 1), seed=0))
    if kind == "stl-fw":
        return schedule_from_result(learn_topology(Pi, budget=budget, lam=lam, device=device))
    raise ValueError(kind)


def next_batch(batcher: TokenBatcher, step: int, pool) -> tuple[np.ndarray, np.ndarray]:
    """``batcher.next_batch(step)``, the nodes' batches drawn on ``pool``'s
    threads."""
    parts = list(pool.map(lambda i: batcher.node_batch(i, step), range(batcher.n_nodes)))
    return np.stack([x for x, _ in parts]), np.stack([y for _, y in parts])


def _join(device: str | None) -> tuple[int, torch.device | str | None]:
    """Under torchrun: join the group; (world size, this rank's device)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1, device
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    cpu = device == "cpu"
    if not cpu:
        torch.cuda.set_device(local)
    dist.init_process_group("gloo" if cpu else "nccl")
    return world, "cpu" if cpu else torch.device("cuda", local)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--per-node-batch", type=int, default=2)
    ap.add_argument("--topology", default="stl-fw",
                    choices=["stl-fw", "random", "ring", "complete"])
    ap.add_argument("--budget", type=int, default=2, help="STL-FW d_max")
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--full", action="store_true", help="the full config (default: smoke)")
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: cuda)")
    args = ap.parse_args(argv)

    world, device = _join(args.device)
    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    n_nodes = args.data
    mesh = None
    if world > 1:
        if world != args.data * args.model:
            raise SystemExit(f"torchrun gave {world} ranks; --data {args.data} x --model "
                             f"{args.model} needs {args.data * args.model}")
        mesh = make_host_mesh(args.data, args.model)
    lead = world == 1 or int(os.environ.get("RANK", "0")) == 0

    # heterogeneous data: one skewed domain mixture per node
    n_domains = max(4, n_nodes // 2)
    corpus = DomainSkewCorpus(vocab_size=cfg.vocab_size, n_domains=n_domains, seed=0)
    Pi = np.full((n_nodes, n_domains), 0.1 / (n_domains - 1))
    Pi[np.arange(n_nodes), np.arange(n_nodes) % n_domains] = 0.9
    Pi /= Pi.sum(1, keepdims=True)
    batcher = TokenBatcher(corpus, Pi, args.per_node_batch, args.seq_len, seed=1)

    schedule = build_topology(args.topology, Pi, args.budget, args.lam,
                              device="cpu" if args.device == "cpu" else None)
    if schedule is not None and lead:
        print(f"topology '{args.topology}': {schedule.n_communication_atoms} "
              f"communication atoms (d_max bound)")

    if mesh is not None:
        setup = make_train_setup(cfg, mesh=mesh, schedule=schedule, lr=args.lr, device=device)
    else:
        setup = make_train_setup(cfg, n_nodes=n_nodes, schedule=schedule, lr=args.lr,
                                 device=device)
    params = setup.init_params(0)
    dev = next(iter(params.values())).device
    logger = MetricLogger()
    pool = ThreadPoolExecutor(max(1, min(n_nodes, os.cpu_count() or 1)))
    t0 = time.time()
    for t in range(args.steps):
        toks, labels = next_batch(batcher, t, pool)
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64),
                 "labels": torch.as_tensor(labels, dtype=torch.int64)}
        b, per, _ = toks.shape
        if cfg.arch_type == "vlm":
            batch["image_embeds"] = torch.zeros((b, per, cfg.vision.num_patches, cfg.d_model),
                                                dtype=dtype_of(cfg))
        if cfg.arch_type == "audio":
            batch["frames"] = torch.zeros((b, per, cfg.encoder.num_frames, cfg.d_model),
                                          dtype=dtype_of(cfg))
            batch["tokens"] = batch["tokens"][..., :448]
            batch["labels"] = batch["labels"][..., :448]
        batch = {k: v.to(dev) for k, v in batch.items()}
        if mesh is not None:
            batch = setup.local_batch(batch)
        params, _, loss = setup.train_step(params, None, batch)
        loss = float(loss)
        logger.log(t, loss=loss)
        if lead and (t % 5 == 0 or t == args.steps - 1):
            print(f"step {t:4d}  loss {loss:.4f}  ({(time.time() - t0) / (t + 1):.2f}s/step)",
                  flush=True)
    if args.ckpt_dir is not None:
        # the stacked layout (node axis first), through train/checkpoints.py;
        # a static schedule has no mixing operand to keep: an empty one
        setup._save(args.ckpt_dir, args.steps, params, None, torch.zeros(0))
        if lead:
            print(f"checkpoint written to {args.ckpt_dir}")
    losses = logger.column("loss")
    if lead:
        print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps")
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
