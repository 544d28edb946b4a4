"""Dry run: one rank's step of every (architecture x input shape) on the
production meshes, on the ``meta`` device under a fake process group of
256 or 512 ranks -- the port's counterpart of the reference's lowering
and compiling on 512 placeholder devices. Nothing is allocated and no
byte moves: ``torch.distributed``'s ``"fake"`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``) joins the
process as rank ``--rank`` of the world, so its mesh coordinates are that
rank's; every collective returns at once.

Per combo this records, for that rank:
  * ``memory.argument_bytes`` -- its parameter blocks (``param_specs``),
    cache block, optimizer state and inputs, from the tensors the step
    takes; ``memory.output_bytes`` -- what it returns;
    ``memory.temp_bytes`` -- the peak of the bytes of meta tensors the
    step made and still holds, tracked by a ``TorchDispatchMode``;
  * ``cost.flops_per_device`` -- ``torch.utils.flop_counter.FlopCounterMode``
    over the step (matrix products, forward and backward), plus each
    kernel launch's FLOPs (``cost.kernel_flops_per_device``): the flash
    and RG-LRU scan wrappers return an empty output on meta and record
    their shapes (``ops.meta_calls``), counted here with the formula of
    ``chip_smoke.py``'s bounds;
  * ``collectives`` -- the bytes a rank receives by kind, from the port's
    own counters (``core.mixing.collective_bytes``: ``tp_all_reduce``,
    ``tp_all_gather``, ``grad_all_reduce``, ``fsdp_all_gather``, the
    gossip's), and by mesh axis (``by_axis``, the same accounting of every
    ``torch.distributed`` collective the step calls, keyed by the axis
    whose group it ran on); ``total_bytes`` is the sum by axis. No HLO is
    parsed;
  * ``scan_trip`` 1: the port's layers are a Python loop, so every layer
    is counted (the reference corrects XLA's once-counted loop bodies).
Written to ``experiments/torch/dryrun/<arch>__<shape>__<mesh>.json``.

Shape kinds: ``train_4k`` runs ``make_train_setup(cfg, mesh=...,
mode=train_mode_for(...), grad_accum=GRAD_ACCUM...)``'s ``train_step``
(with recomputation, the reference's default); ``prefill_32k`` the
sharded prefill (``serve.engine.make_serve_setup(...).prefill``, flash
under ``impl="kernel"``); ``decode_32k`` / ``long_500k`` its
``serve_step`` (one token against a ``seq_len`` cache; ``long_500k`` in
the long-context mode). ``SKIPS`` are the reference's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes --subprocess --jobs 4

(xlstm-350m's sLSTM time loop runs step by step on meta: its train_4k and
prefill_32k combos take tens of minutes of one core each.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import MESHES

__all__ = ["SKIPS", "GRAD_ACCUM", "MESHES", "train_mode_for", "join_fake", "run_one",
           "kernel_flops", "main"]

SKIPS: dict[tuple[str, str], str] = {
    ("whisper-small", "decode_32k"): "enc-dec ASR: decoder max target len 448",
    ("whisper-small", "long_500k"): "enc-dec ASR: decoder max target len 448",
}

# archs whose activations exceed a card at the full step's batch accumulate
# gradients over microbatches (the reference's policy)
GRAD_ACCUM = {"deepseek-v2-236b": 8, "qwen3-moe-30b-a3b": 2}

DEFAULT_OUT = os.path.join("experiments", "torch", "dryrun")


def train_mode_for(arch: str, multi_pod: bool) -> str:
    if multi_pod:
        return "dsgd_pod"
    if arch == "deepseek-v2-236b":
        return "fsdp"  # 16 replicas do not fit a pod
    return "dsgd"


def join_fake(world: int, rank: int = 0) -> None:
    """Join the fake process group as ``rank`` of ``world`` (leaving a
    group of another size or rank first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def _kept_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs a causal attention of S positions keeps."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def kernel_flops(flash_calls: list[dict], scan_calls: list[dict]) -> float:
    """The FLOPs of the kernel launches the wrappers recorded on meta:
    flash 4 B H D kept pairs (Q K^T and P V), the scan 2 B S D."""
    flash = sum(4.0 * c["B"] * c["H"] * c["D"] * (_kept_pairs(c["S"], c["window"])
                                                   if c["causal"] else c["S"] ** 2)
                for c in flash_calls)
    return flash + sum(2.0 * c["B"] * c["S"] * c["D"] for c in scan_calls)


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


class _LiveBytes(TorchDispatchMode):
    """Tracks the bytes of the meta storages the ops make while the tensor
    that first held each is alive, and their peak."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set = set()

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                st = t.untyped_storage()
                key = st._cdata
                if key in self._seen:
                    continue
                n = st.nbytes()
                self._seen.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, key, n)
        return out


class _CollectiveSpy:
    """Counts the bytes a rank receives in every ``torch.distributed``
    collective, by the mesh axis whose group it runs on (the counters'
    accounting: an all-reduce 2 (n - 1) / n of the buffer, an all-gather
    (n - 1) blocks, a reduce-scatter (n - 1) output blocks, a gather or
    point-to-point what arrives)."""

    _NAMES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "gather",
              "batch_isend_irecv")

    def __init__(self, mesh):
        import torch.distributed as dist

        self.dist = dist
        self.by_axis: dict[str, int] = {}
        self.axis_of = {}
        for name in mesh.mesh_dim_names:
            ranks = tuple(sorted(dist.get_process_group_ranks(mesh.get_group(name))))
            self.axis_of.setdefault(ranks, name)
        self._saved: dict = {}

    def _axis(self, group) -> str:
        """The mesh axis whose group ``group`` is (an axis over every rank
        may run on the default group), else ``"world"``."""
        d = self.dist
        ranks = tuple(sorted(d.get_process_group_ranks(group or d.group.WORLD)))
        return self.axis_of.get(ranks, "world")

    def _add(self, group, nbytes: int) -> None:
        axis = self._axis(group)
        self.by_axis[axis] = self.by_axis.get(axis, 0) + int(nbytes)

    def __enter__(self):
        d = self.dist

        def size(g):
            return d.get_world_size(g)

        def all_reduce(t, *a, group=None, **k):
            n = size(group)
            self._add(group, 2 * (n - 1) * t.numel() * t.element_size() // n)
            return self._saved["all_reduce"](t, *a, group=group, **k)

        def all_gather_into_tensor(out, inp, *a, group=None, **k):
            self._add(group, (size(group) - 1) * inp.numel() * inp.element_size())
            return self._saved["all_gather_into_tensor"](out, inp, *a, group=group, **k)

        def reduce_scatter_tensor(out, inp, *a, group=None, **k):
            self._add(group, (size(group) - 1) * out.numel() * out.element_size())
            return self._saved["reduce_scatter_tensor"](out, inp, *a, group=group, **k)

        def gather(t, gather_list=None, *a, group=None, **k):
            if gather_list:
                self._add(group, (len(gather_list) - 1) * t.numel() * t.element_size())
            return self._saved["gather"](t, gather_list, *a, group=group, **k)

        def batch_isend_irecv(ops):
            for op in ops:
                if op.op is d.irecv:
                    self._add(op.group, op.tensor.numel() * op.tensor.element_size())
            return self._saved["batch_isend_irecv"](ops)

        for name in self._NAMES:
            self._saved[name] = getattr(d, name)
            setattr(d, name, locals()[name])
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.dist, name, fn)


def _meta_params(specs: dict, shapes: dict, sizes: dict) -> dict:
    from repro_torch.serve.engine import _block_shape

    return {k: torch.empty(_block_shape(shapes[k][0], spec, sizes), dtype=shapes[k][1],
                           device="meta") for k, spec in specs.items()}


def _model_shapes(cfg) -> dict:
    from repro_torch.models import transformer, whisper

    meta = whisper.Whisper(cfg, "meta") if cfg.arch_type == "audio" else \
        transformer.LM(cfg, "meta")
    return {k: (tuple(p.shape), p.dtype) for k, p in meta.named_parameters()}


def _example(cfg, lead: tuple, S: int, labels: bool) -> dict:
    """Meta inputs of ``registry.make_inputs``'s shapes with ``lead``
    leading dimensions (whisper's 448 tokens and frames, the VLM's
    patches)."""
    from repro_torch.models import registry

    one = registry.make_inputs(cfg, 1, S, device="cpu")
    return {k: torch.empty(lead + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
            for k, v in one.items() if labels or k != "labels"}


def _step(arch: str, cfg, shape: dict, mesh, multi_pod: bool):
    """Build the combo's step; returns (its record's mode fields, inputs,
    run) where ``run()`` runs the step once on meta and returns its
    outputs."""
    from repro_torch.serve.engine import make_serve_setup
    from repro_torch.train import sharding
    from repro_torch.train.lm_trainer import make_train_setup

    sizes = sharding.mesh_sizes(mesh)
    B, S = shape["global_batch"], shape["seq_len"]
    shapes = _model_shapes(cfg)
    if shape["kind"] == "train":
        mode = train_mode_for(arch, multi_pod)

        def setup_of(accum: int):
            return make_train_setup(cfg, mesh=mesh, mode=mode, lr=1e-3, remat=True,
                                    grad_accum=accum, device="meta")

        setup = setup_of(1)
        n = setup.n_nodes
        lead = (B,) if mode == "fsdp" else (n, B // n)
        batch = setup.local_batch(_example(cfg, lead, S, labels=True))
        # the reference splits the global batch into GRAD_ACCUM microbatches;
        # a rank splits its own rows, into at most as many as it has
        rows = batch["tokens"].shape[0]
        accum = max(d for d in range(1, GRAD_ACCUM.get(arch, 1) + 1) if rows % d == 0)
        if accum > 1:
            setup = setup_of(accum)
        params = _meta_params(setup.param_specs, shapes, sizes)
        return {"mode": mode, "grad_accum": accum}, \
            {"params": params, "batch": batch}, \
            lambda: setup.train_step(params, None, batch)[2]
    if shape["kind"] == "prefill":
        inputs = _example(cfg, (B,), S, labels=False)
        max_len = (inputs["tokens"].shape[1] if cfg.arch_type == "audio" else S) + 8
        setup = make_serve_setup(cfg, mesh, batch=B, seq_len=max_len, device="meta")
        params = _meta_params(setup.param_specs, shapes, sizes)
        cache = setup.init_cache()
        local = {k: setup.local_batch(v) for k, v in inputs.items()}
        tokens = local.pop("tokens")
        return {"mode": "serve_prefill"}, {"params": params, "cache": cache, "inputs": local,
                                           "tokens": tokens}, \
            lambda: setup.prefill(params, tokens, cache, **local)
    long = shape["kind"] == "decode_long"
    setup = make_serve_setup(cfg, mesh, batch=B, seq_len=S, long_context=long, device="meta")
    params = _meta_params(setup.param_specs, shapes, sizes)
    cache = setup.init_cache()
    token = setup.local_batch(torch.empty((B, 1), dtype=torch.int64, device="meta"))
    position = torch.empty_like(token)
    return {"mode": "serve_decode" + ("_long" if long else "")}, \
        {"params": params, "cache": cache, "token": token, "position": position}, \
        lambda: setup.serve_step(params, token, position, cache)[0]


def run_one(arch: str, shape_name: str, mesh_name: str, out_dir: str | None = DEFAULT_OUT, *,
            rank: int = 0, shape: dict | None = None, cfg=None) -> dict:
    """One combo on rank ``rank`` of the fake group of ``mesh_name``'s
    size; writes and returns its record (``out_dir`` None: not written).
    ``cfg`` / ``shape``: this config / input shape instead of ``arch``'s
    full config / ``INPUT_SHAPES[shape_name]`` (the record is marked
    ``custom``; the roofline skips it)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import mixing as M
    from repro_torch.device import shapes_only
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.train import sharding

    key = f"{arch}__{shape_name}__{mesh_name}"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if (arch, shape_name) in SKIPS:
        rec = {**base, "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
        _write(out_dir, key, rec)
        print(f"SKIP {key}: {rec['reason']}")
        return rec
    custom = shape is not None or cfg is not None
    shape = shape or INPUT_SHAPES[shape_name]
    mesh_shape, names = MESHES[mesh_name]
    t0 = time.time()
    try:
        join_fake(math.prod(mesh_shape), rank)
        mesh = sharding.make_mesh(mesh_shape, names, device_type="cpu")
        cfg = cfg or get_config(arch)
        grad = contextlib.nullcontext() if shape["kind"] == "train" else torch.no_grad()
        with shapes_only(), grad:
            mode, inputs, run = _step(arch, cfg, shape, mesh, "pod" in names)
            t_build = time.time() - t0
            M.reset_collective_bytes()
            fa_ops.meta_calls.clear()
            scan_ops.meta_calls.clear()
            flops = FlopCounterMode(display=False)
            live = _LiveBytes()
            with _CollectiveSpy(mesh) as spy, flops, live:
                out = run()
        kflops = kernel_flops(fa_ops.meta_calls, scan_ops.meta_calls)
        by_kind = {k: int(v) for k, v in M.collective_bytes.items() if v}
        rec = {
            **base, "status": "ok", **mode, "rank": rank,
            "coords": sharding.mesh_coords(mesh), "custom": custom,
            "build_s": round(t_build, 1), "run_s": round(time.time() - t0 - t_build, 1),
            "memory": {"argument_bytes": _nbytes(inputs), "output_bytes": _nbytes(out),
                       "temp_bytes": live.peak},
            "cost": {"flops_per_device": float(flops.get_total_flops()) + kflops,
                     "kernel_flops_per_device": kflops,
                     "kernel_calls": {"flash_attention": len(fa_ops.meta_calls),
                                      "rglru_scan": len(scan_ops.meta_calls)}},
            "collectives": {**by_kind, "calls": {k: int(v) for k, v in
                                                 M.collective_calls.items() if v},
                            "by_axis": dict(spy.by_axis),
                            "total_bytes": int(sum(spy.by_axis.values()))},
            "scan_trip": 1,
        }
        print(f"OK   {key}: {rec['run_s']:.0f}s | temp {live.peak / 2**30:.2f} GiB/dev | "
              f"args {rec['memory']['argument_bytes'] / 2**30:.2f} GiB/dev | coll "
              f"{rec['collectives']['total_bytes'] / 2**20:.1f} MiB/dev", flush=True)
    except Exception as e:  # noqa: BLE001 - record failures, don't crash the sweep
        rec = {**base, "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        print(f"FAIL {key}: {rec['error'][:200]}", flush=True)
    _write(out_dir, key, rec)
    return rec


def _write(out_dir: str | None, key: str, rec: dict) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, key + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _run_subprocess(arch: str, shape: str, mesh_name: str, out_dir: str, rank: int,
                    timeout: float = 3600) -> dict:
    """One combo in a process of its own, its record read back."""
    import subprocess

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh_name, "--out", out_dir, "--rank", str(rank)]
    key = f"{arch}__{shape}__{mesh_name}"
    path = os.path.join(out_dir, key + ".json")
    if os.path.exists(path):
        os.remove(path)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        rc, tail = proc.returncode, proc.stderr[-1500:]
        sys.stdout.write(proc.stdout)
    except subprocess.TimeoutExpired as e:
        rc, tail = "timeout", str(e)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "error",
           "error": f"process died (rc={rc})", "stderr_tail": tail}
    _write(out_dir, key, rec)
    print(f"FAIL {key}: process died rc={rc}")
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None, choices=list(MESHES),
                    help="a named mesh (overrides --multi-pod / --both-meshes)")
    ap.add_argument("--rank", type=int, default=0, help="the rank whose step runs")
    ap.add_argument("--subprocess", action="store_true",
                    help="isolate each combo in its own process")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --subprocess, combos run at once (each on one core)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    if args.mesh:
        meshes = [args.mesh]
    else:
        meshes = ["16x16", "2x16x16"] if args.both_meshes else \
            ["2x16x16" if args.multi_pod else "16x16"]
    combos = [(a, sh, m) for m in meshes for a in archs for sh in shapes]
    if args.subprocess:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            recs = list(pool.map(lambda c: _run_subprocess(*c, args.out, args.rank), combos))
    else:
        recs = [run_one(a, sh, m, args.out, rank=args.rank) for a, sh, m in combos]
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_fail = sum(r["status"] == "error" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    print(f"\ndry-run summary: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
