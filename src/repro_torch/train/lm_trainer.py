"""LM D-SGD training: the reference's mesh trainer
(``repro/train/lm_trainer.py``) with the node axis stacked on one device,
with one node per rank of a ``torch.distributed`` group, or on the
reference's ``(data, model)`` / ``(pod, data, model)`` mesh of ranks.

The reference runs one D-SGD node per index of its ``data`` mesh axis and
mixes with collectives. The port has three layouts:

* **Stacked** (``n_nodes=``, no ``group``): the ``n`` replicas on one
  card, as the simulator stacks them (``train/trainer.py``): every
  parameter is a tensor of shape ``(n, ...)``, named as
  ``LM.named_parameters()`` (``convert.lm_stacked_from_numpy`` carries the
  reference's ``init_params`` over), and mixing is
  ``core.mixing.mix_stacked`` -- on the card the ``gossip_schedule``
  kernel for a schedule or a ``ScheduleArrays``, the ``gossip_mix``
  kernel for a dense W and the complete graph.
* **One node per rank** (``group=`` a process group; the reference's
  ``shard_map`` over ``data``): every rank holds one whole replica (no
  tensor parallelism), a dict of tensors without a node axis
  (``convert.lm_node_from_numpy``), and its own batch ``(per_node,
  ...)``; its rank in the group is the node index. The mix is a
  collective of ``core.mixing``: a static schedule by ``mix_ppermute``,
  the complete graph by ``mix_allreduce``, and with ``online_w`` the
  ``sharded_transport`` ``"allgather"`` (a W or a ``ScheduleArrays`` as
  data: ``mix_dense_sharded`` / ``mix_arrays_sharded``) or ``"pool"``
  (``mix_ppermute_pool`` over ``pool=``, the pool's gammas as data;
  ``"auto"`` looks the measured table up). The step's loss is the mean
  over ranks. ``compression=`` (EF gossip, the memory in the opt state
  under ``"ef"``), ``staleness=`` (bounded delay: a sender-side ring
  under ``"stale"``, per-step operands and delays) and ``probes=``
  (``consensus`` and ``grad_dev`` as collectives; ``tau_bar`` refused)
  ride the same step. NCCL collectives are captured with the rollout's
  bodies; gloo's host-side work cannot be, so ``rollout="scan"`` is
  refused on a gloo group.
* **A mesh** (``mesh=`` a ``DeviceMesh`` named as the reference's axes;
  ``train/mesh_layout.py``): ``dsgd`` on ``(data, model)`` -- a node a
  ``data`` coordinate, its replica split over ``model`` by the
  reference's rules (``train/sharding.py``) and run tensor-parallel
  (``train/tensor_parallel.py``), the mix one rank-layout transport over
  the ``data`` group on local blocks (block k of a node mixes with block
  k of the others: the reference's math elementwise); ``fsdp`` -- one
  model split over every rank at rest, gathered for the step, the batch
  split over every rank, the gradient's mean cut back; ``dsgd_pod`` on
  ``(pod, data, model)`` -- a node a pod, weights at rest split over
  ``data`` and ``model``, a pod's batch over ``data``, the pods mixed by
  the dense W (``mix_dense_sharded`` over the ``pod`` group). Checkpoints
  write the stacked layout whole (each leaf gathered over ``model``,
  then ``data``, then stacked over nodes to the first rank); every rank
  restores its block.

Modes:

* ``dsgd`` -- each step takes every node's gradient on its own batch
  (stacked: one autograd pass per node over views ``leaf[i]``, in a
  Python loop, so each node's activations are freed before the next),
  the local SGD (momentum) half-step, then the mix: a static
  ``BirkhoffSchedule`` (``schedule=None``: the complete graph), or with
  ``online_w=True`` the step's trailing ``mix_w`` operand.
* ``fsdp`` -- one global model on a ``(batch, ...)`` batch, no node axis
  (the reference's C-PSGD baseline, W = 11^T / n), on one device or a
  mesh.
* ``dsgd_pod`` -- pods are the nodes (a mesh only), mixing every step.

``impl`` picks the full-sequence attention (``models/attention.py``).
``"kernel"`` trains through the flash-attention kernel, which has a
backward for bfloat16 on the card (``kernels/flash_attention``; on the
CPU autograd differentiates its plain version); it is refused for a
config with RG-LRU layers (the scan kernel has no backward) and for a
float32 or float16 config on the card. ``impl=None`` resolves to
``"kernel"`` on a CUDA device wherever it would not be refused, else to
``"plain"`` (plain PyTorch attention under autograd, as on the CPU).

``TrainSetup.multi_step_fn(rollout)`` is the counterpart of the
reference's ``lax.scan`` rollout: ``"scan"`` runs the steps as captured
bodies of at most ``rollout.MAX_GRAPH_STEPS`` steps (``graphs.GraphRunner``:
an eager warm-up on a side stream, a CUDA-graph capture at a body's
second run, replays after), with the parameters, the opt state (momentum,
step counter, EF memory, stale ring) and the gradient buffers as static
carries and each step's batch (and, under staleness, its operand and
delays) a static input; ``"loop"`` runs the same bodies eagerly. Both run
the same operations on the same tensors (bitwise equal on the card). A
swapped mixing operand reaches the bodies by ``copy_`` into their static
operand, so it recaptures nothing.

``gossip_every = k > 1`` mixes on the steps whose counter is a multiple
of k. The reference branches on its device counter (``lax.cond``); a
CUDA graph freezes host branches, so here each body's on/off pattern is
static: bodies are keyed by the counter's phase at their first step,
read on the host once per multi-step call (outside any capture). Off
steps launch no mixing kernel and run no collective.

``TrainSetup.run_segments`` is the reference's segmented online rollout:
a hook that swaps W, a ``ScheduleArrays`` or a ``PoolSwap`` at
boundaries, checkpoints (``train/checkpoints.py``, bfloat16 leaves by
their bits; one node per rank, rank 0 writes the stacked layout and
every rank restores its own row) with a bitwise resume, a tracer and a
retrace guard, ``delays=`` and ``quarantine=``; with probes it returns
the ``"health"`` series.

Every layout takes the same robustness options. Stacked, the pool's
(capacity,) gammas mix as the ``ScheduleArrays`` of its permutations
(one ``gossip_schedule`` launch; ``"auto"`` picks by the closed form on
the reference's bytes: both run the same kernel), and ``compression=``
/ ``staleness=`` mix in the gossip kernels with the rank transports'
numerics (``core.compression.mix_stacked_ef`` /
``mix_arrays_stacked_stale_ef``, ``core.mixing.mix_arrays_stacked_stale``:
float32 payloads, one rounding of each combine), the EF memory and the
node-first ring (leaves ``(n, depth, ...)``, the reference's stacked
layout) updated in place; ``probes=`` sums the spread over the node axis
(``spread_sq_stacked``). Tensor parallelism covers every family
(``tensor_parallel.make_plan``). Serving on the same meshes is
``serve.engine.make_serve_setup``; ``launch/train.py`` drives this
trainer from the command line, ``launch/dryrun.py`` runs its step on a
fake process group of the production meshes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.core.compression import (
    Compressor,
    make_compressor,
    mix_arrays_sharded_ef,
    mix_arrays_sharded_stale_ef,
    mix_arrays_stacked_stale_ef,
    mix_dense_sharded_ef,
    mix_ppermute_pool_ef,
    mix_ppermute_pool_stale_ef,
    mix_stacked_ef,
)
from repro_torch.core.mixing import (
    BirkhoffSchedule,
    PermPool,
    PoolSwap,
    ScheduleArrays,
    ShardStaleState,
    StragglerPolicy,
    _gather_first,
    _pmean,
    _psum,
    autotune_sharded_transport,
    axis_index,
    axis_size,
    group_backend,
    mix_allreduce,
    mix_arrays_sharded,
    mix_arrays_sharded_stale,
    mix_arrays_stacked_stale,
    mix_dense,
    mix_dense_sharded,
    mix_ppermute,
    mix_ppermute_pool,
    mix_ppermute_pool_stale,
    mix_schedule_arrays,
    mix_stacked,
    preferred_sharded_transport,
    spread_sq_stacked,
    stale_ring_dtype,
    straggler_pool_stream,
    straggler_stream,
)
from repro_torch.device import resolve_device
from repro_torch.graphs import Body, GraphRunner, release
from repro_torch.models import registry, transformer, whisper
from repro_torch.models.common import IMPLS, ModelConfig, dtype_of
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.obs.probes import HealthProbes
from repro_torch.obs.trace import Tracer

from . import tensor_parallel
from .checkpoints import latest_step, restore_checkpoint, save_checkpoint, tree_leaves
from .mesh_layout import MeshLayout
from .metrics import CommMeter, mix_bytes_per_step, staleness_transfer_fracs
from .rollout import chunks

__all__ = ["TrainSetup", "make_train_setup", "gossip_fn"]

PyTree = Any
Params = dict[str, torch.Tensor]

# instrumented paths take an always-on tracer; callers opt in with a real one
_NULL_TRACER = Tracer(enabled=False)

# keys of a body's per-step inputs that are not the model's batch: under
# staleness each step's mixing operand and delay vector
_GAMMAS, _PERMS, _DELAYS = "__gammas", "__perms", "__delays"
_OPT_KEYS = {"step", "m", "ef", "stale"}
_STALE_DENSE = ("staleness needs a per-sender payload to delay: pass mix_w as ScheduleArrays "
                "(allgather) or pool gammas, not a dense (n, n) W")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().clone()


def _copy_into(dst, src) -> None:
    """``src`` into the static tensors of ``dst`` (same structure), in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif dst is not None and src is not dst:
        dst.copy_(src)


def _is_carry_dict(opt) -> bool:
    """Whether ``opt`` is the ``{"step", "m", "ef", "stale"}`` dict of the
    reference's convention (a bare momentum tree is keyed by parameter
    names)."""
    return isinstance(opt, dict) and bool(opt) and set(opt) <= _OPT_KEYS


def _leading(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


class _Loss(nn.Module):
    """The model's loss and gradients as a module, for
    ``torch.func.functional_call``: the backward pass runs inside the call,
    where the given tensors are the module's parameters (the forward's
    recomputed blocks read them there)."""

    def __init__(self, model: nn.Module, cfg: ModelConfig, impl: str, remat: bool):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.impl = impl
        self.remat = remat

    def forward(self, batch: dict, names: list[str]) -> tuple[torch.Tensor, tuple]:
        loss = registry.loss_fn(self.model, self.cfg, batch, impl=self.impl,
                                remat=self.remat)[0]
        params = dict(self.named_parameters())
        return loss.detach(), torch.autograd.grad(loss, [params[k] for k in names])


def gossip_fn(schedule: BirkhoffSchedule | None, n_nodes: int, *, use_kernel: bool = False,
              group=None) -> Callable[[Params], Params]:
    """The static mixing: the Birkhoff schedule, or with ``schedule=None``
    the complete graph, W = 11^T / n. Stacked parameters mix through
    ``mix_stacked`` (``gossip_schedule`` / ``gossip_mix`` on the card;
    ``use_kernel`` gives the kernels' float32 sums on the CPU, without it
    the CPU sums in the leaf dtype); with ``group``, one node per rank,
    through ``mix_ppermute`` / ``mix_allreduce``."""
    if schedule is not None and schedule.n_nodes != n_nodes:
        raise ValueError(f"schedule has {schedule.n_nodes} nodes, the setup {n_nodes}")
    if schedule is None and n_nodes == 1:
        return lambda params: params  # one node: its mean is itself, bitwise
    if group is not None:
        if schedule is not None:
            return lambda params: mix_ppermute(params, schedule, group)
        return lambda params: mix_allreduce(params, group)
    if schedule is not None:
        return lambda params: mix_stacked(params, schedule=schedule, transport="schedule",
                                          use_kernel=use_kernel)
    complete: dict[torch.device, torch.Tensor] = {}

    def mix(params: Params) -> Params:
        device = next(iter(params.values())).device
        if device not in complete:
            complete[device] = torch.full((n_nodes, n_nodes), 1.0 / n_nodes,
                                          dtype=torch.float32, device=device)
        return mix_dense(params, complete[device], use_kernel=use_kernel)

    return mix


def _sgd_update(params: Params, grads: Params, momentum_state: Params | None, lr: float,
                momentum: float) -> tuple[Params, Params | None]:
    """The local half-step: ``p - lr g``, or with heavy-ball momentum
    ``m' = momentum m + g``, ``p - lr m'``; in the leaves' dtype."""
    if momentum > 0.0:
        new_m = {k: momentum * momentum_state[k] + grads[k] for k in params}
        return {k: params[k] - lr * new_m[k] for k in params}, new_m
    return {k: params[k] - lr * grads[k] for k in params}, momentum_state


def _static_operand(mix, device: torch.device, pool_gammas: bool = False):
    """A mixing operand as the tensors the step reads: a ScheduleArrays
    (float32 gammas, int32 perms), a float32 (n, n) W, or (``pool_gammas``:
    the pool transport) the pool's (capacity,) float32 gammas."""
    if isinstance(mix, PoolSwap):
        raise TypeError("a PoolSwap is a run_segments hook's return; pass its gammas as mix_w")
    if isinstance(mix, ScheduleArrays):
        return ScheduleArrays(
            gammas=torch.as_tensor(mix.gammas, dtype=torch.float32, device=device),
            perms=torch.as_tensor(mix.perms, dtype=torch.int32, device=device))
    if isinstance(mix, torch.Tensor):
        w = mix.detach().to(device=device, dtype=torch.float32)
    else:
        w = torch.as_tensor(np.asarray(mix, dtype=np.float32), device=device)
    if pool_gammas:
        if w.ndim != 1:
            raise ValueError(f"the pool transport takes (capacity,) gammas, got {tuple(w.shape)}")
        return w
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        if w.ndim == 1:
            raise ValueError("pool-coordinate gammas take the pool transport "
                             "(sharded_transport='pool'); run_segments runs them on the "
                             "all-gather transport as the pool's ScheduleArrays twin")
        raise ValueError(f"mix_w must be an (n, n) W or a ScheduleArrays, got {tuple(w.shape)}")
    return w


def _operand_key(mix) -> tuple:
    if mix is None:
        return ("static",)
    if isinstance(mix, ScheduleArrays):
        return ("arrays", mix.l_max)
    if mix.ndim == 1:
        return ("pool", mix.shape[0])
    return ("dense",)


def _spread_sq(tree: Params, group, layout: MeshLayout | None = None) -> torch.Tensor:
    """``sum_leaves sum_i ||x_i - mean_j x_j||^2`` over the ranks, float32:
    the reference's collective probe (a pmean and a psum a leaf). On a
    mesh a leaf split over ``model`` holds a block a rank: its blocks'
    sums are added over ``model``; a replicated leaf (a norm scale) is
    counted once."""
    tot = split = None
    for name, x in tree.items():
        xf = x.to(torch.float32)
        dev = _psum(torch.sum(torch.square(xf - _pmean(xf, group))), group)
        if layout is not None and layout.model_split(name):
            split = dev if split is None else split + dev
        else:
            tot = dev if tot is None else tot + dev
    if split is not None:
        split = _psum(split, layout.group("model"))
        tot = split if tot is None else tot + split
    return tot


class _Step:
    """The step's math, shared by ``train_step`` and the rollouts: every
    function here reads and writes the tensors it is given in place."""

    def __init__(self, cfg: ModelConfig, *, mode: str, n_nodes: int, lr: float,
                 momentum: float, impl: str, grad_accum: int, gossip_every: int,
                 online_w: bool, schedule: BirkhoffSchedule | None, device: torch.device,
                 group=None, transport: str | None = None, pool: PermPool | None = None,
                 compressor: Compressor | None = None,
                 staleness: StragglerPolicy | None = None, probes: HealthProbes | None = None,
                 remat: bool = False, layout: MeshLayout | None = None):
        self.mode, self.n_nodes = mode, n_nodes
        self.cfg, self.remat, self.layout = cfg, remat, layout
        self.lr, self.momentum = lr, momentum
        self.grad_accum, self.gossip_every = grad_accum, gossip_every
        self.device = device
        self.group, self.ranks = group, group is not None or layout is not None
        self.online_w, self.transport, self.pool = online_w, transport, pool
        self.compressor, self.staleness, self.probes = compressor, staleness, probes
        meta = whisper.Whisper(cfg, "meta") if cfg.arch_type == "audio" else \
            transformer.LM(cfg, "meta")
        self.loss_module = _Loss(meta, cfg, impl, remat)
        # the model's buffers on the device (whisper's decoder position
        # table): functional_call is given them beside the parameters
        self.buffers = {} if cfg.arch_type != "audio" else {
            "model.positions": sinusoidal_positions(whisper.MAX_POSITIONS, cfg.d_model,
                                                    dtype_of(cfg), device)}
        # the held-expert MoE layers' load counters (``models/moe.py``): every
        # node's forward adds to them, inside a captured body too
        self.buffers.update({"model." + name: torch.zeros(b.shape, dtype=b.dtype, device=device)
                             for name, b in meta.named_buffers() if name.endswith(".load")})
        self.static_mix = gossip_fn(schedule, n_nodes, group=group) \
            if mode == "dsgd" and not online_w else None
        # dsgd_pod's static mix: the schedule's W, or the complete graph
        self.pod_w = None if mode != "dsgd_pod" or online_w else torch.as_tensor(
            schedule.to_matrix() if schedule is not None else
            np.full((n_nodes, n_nodes), 1.0 / n_nodes), dtype=torch.float32, device=device)
        # a node's replica split over model: the tensor-parallel forward
        self.tp = tensor_parallel.TPGroup.of(layout.tp_group if layout is not None else None)
        # a node's batch split over ranks: an MoE aux loss takes whole-batch
        # statistics, so the forward is tensor_parallel's there too
        self.batch_groups = () if layout is None or cfg.moe is None else tuple(
            tensor_parallel.TPGroup.of(layout.group(a)) for a in layout.batch_axes
            if layout.sizes[a] > 1)
        self.plan = tensor_parallel.make_plan(cfg, layout.compute_specs, self.tp.size) \
            if self.tp.size > 1 or self.batch_groups else None
        # stacked on the pool transport: the (capacity,) gammas mix over the
        # pool's staged permutations, a ScheduleArrays (made before any capture)
        self.pool_perms = None if pool is None or self.ranks else torch.as_tensor(
            np.asarray(pool.perms, np.int32).reshape(pool.capacity, pool.n_nodes), device=device)

    @property
    def outputs(self) -> tuple[str, ...]:
        """The names of a step's outputs: the loss, then the probes."""
        return ("loss",) + (self.probes.names() if self.probes is not None else ())

    # -- gradients -----------------------------------------------------------

    def _loss_grads(self, leaves: Params, batch: dict) -> tuple[torch.Tensor, Params]:
        """One model's loss and gradients on ``batch`` (leading axis the
        batch); with ``grad_accum`` the mean over its microbatches,
        accumulated in float32 and cast to the leaves' dtype."""
        named = {"model." + k: v.detach().requires_grad_() for k, v in leaves.items()}
        keys = list(named)

        def one(b: dict):
            if self.plan is not None:
                loss = tensor_parallel.lm_loss({k: named["model." + k] for k in leaves},
                                               self.cfg, b, self.plan, self.tp,
                                               remat=self.remat,
                                               batch_groups=self.batch_groups,
                                               impl=self.loss_module.impl)
                return loss.detach(), torch.autograd.grad(loss, [named[k] for k in keys])
            return torch.func.functional_call(self.loss_module, {**named, **self.buffers},
                                              (b, keys))

        if self.grad_accum == 1:
            loss, grads = one(batch)
            return loss, dict(zip(leaves, grads))
        micro = _leading(batch) // self.grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = [torch.zeros(named[k].shape, dtype=torch.float32, device=self.device)
               for k in keys]
        for a in range(self.grad_accum):
            loss, grads = one({k: v[a * micro:(a + 1) * micro] for k, v in batch.items()})
            loss_sum = loss_sum + loss
            for s, g in zip(acc, grads):
                s.add_(g)
        grads = {name: (s / self.grad_accum).to(leaves[name].dtype)
                 for name, s in zip(leaves, acc)}
        return loss_sum / self.grad_accum, grads

    def grads_(self, params: Params, batch: dict, out: Params) -> torch.Tensor:
        """Every node's gradient into ``out`` (in place); the per-node losses
        (n,) in float32 -- fsdp and one node per rank: the model's loss, a
        0-d tensor. On a mesh the leaves at rest are gathered for the pass
        and the gradients' mean over the batch's ranks cut back to them;
        the loss is this rank's."""
        if self.layout is not None:
            full = {k: self.layout.gather(v, k) for k, v in params.items()}
            loss, grads = self._loss_grads(full, batch)
            del full
            for k, g in grads.items():
                out[k].copy_(self.layout.reduce_grad(g, k))
            return loss
        if self.mode == "fsdp" or self.ranks:
            loss, grads = self._loss_grads(params, batch)
            _copy_into(out, grads)
            return loss
        losses = []
        for i in range(self.n_nodes):
            loss, grads = self._loss_grads({k: v[i] for k, v in params.items()},
                                           {k: v[i] for k, v in batch.items()})
            for k, g in grads.items():
                out[k][i].copy_(g)
            losses.append(loss)
            del grads
        return torch.stack(losses)

    # -- the step --------------------------------------------------------------

    def mix(self, half: Params, opt, operand, delays) -> tuple[Params, Params | None]:
        """Stacked nodes: ``(mixed, new_ef)``, the reference's ``do_mix`` /
        ``do_mix_ef`` / stale dispatch with its node axis stacked. The pool
        transport's gammas mix as the ``ScheduleArrays`` of the pool's
        permutations; every mix runs in the gossip kernels on the card
        (the EF and stale twins in the rank transports' float32 numerics:
        ``core.compression.mix_stacked_ef``, ``mix_arrays_stacked_stale``);
        the EF memory and the ring in ``opt`` are updated in place."""
        ef = opt.get("ef") if _is_carry_dict(opt) else None
        if operand is None:
            return self.static_mix(half), ef
        w, c = operand, self.compressor
        if self.pool_perms is not None and isinstance(w, torch.Tensor) and w.ndim == 1:
            w = ScheduleArrays(gammas=w, perms=self.pool_perms)
        if self.staleness is not None:
            if not isinstance(w, ScheduleArrays):
                raise TypeError(_STALE_DENSE)
            rings, head = opt["stale"]["buf"], opt["stale"]["head"]
            if c is not None:
                return mix_arrays_stacked_stale_ef(half, ef, rings, head, w, delays, c)
            return mix_arrays_stacked_stale(half, rings, head, w, delays), ef
        if c is not None:
            return mix_stacked_ef(half, ef, w, c)
        if isinstance(w, ScheduleArrays):
            return mix_schedule_arrays(half, w), ef
        return mix_dense(half, w), ef

    def mix_rank(self, half: Params, opt, operand, delays) -> tuple[Params, Params | None]:
        """One node per rank: ``(mixed, new_ef)`` by the setup's transport
        (the reference's ``do_mix`` / ``do_mix_ef`` / stale dispatch); the
        stale ring in ``opt`` is pushed in place."""
        g, c, w = self.group, self.compressor, operand
        ef = opt.get("ef") if _is_carry_dict(opt) else None
        if self.mode == "dsgd_pod":
            w = w if self.online_w else self.pod_w
            if isinstance(w, ScheduleArrays) or w.ndim != 2:
                raise TypeError("dsgd_pod online mixing is the dense einsum over the pod axis: "
                                "pass mix_w as a dense (n, n) W (pool gammas / ScheduleArrays "
                                "are dsgd-mode operands)")
            return mix_dense_sharded(half, w, g), ef
        pool = self.transport == "pool"
        if self.staleness is not None:
            st = ShardStaleState(rings=opt["stale"]["buf"], head=opt["stale"]["head"])
            if not pool and not isinstance(w, ScheduleArrays):
                raise TypeError(_STALE_DENSE)
            if c is not None:
                mixed, ef, _ = (
                    mix_ppermute_pool_stale_ef(half, ef, st, w, self.pool, delays, g, c) if pool
                    else mix_arrays_sharded_stale_ef(half, ef, st, w, delays, g, c))
            else:
                mixed, _ = (mix_ppermute_pool_stale(half, st, w, self.pool, delays, g) if pool
                            else mix_arrays_sharded_stale(half, st, w, delays, g))
            return mixed, ef
        if c is not None:
            if pool:
                return mix_ppermute_pool_ef(half, ef, w, self.pool, g, c)
            if isinstance(w, ScheduleArrays):
                return mix_arrays_sharded_ef(half, ef, w, g, c)
            return mix_dense_sharded_ef(half, ef, w, g, c)
        if not self.online_w:
            return self.static_mix(half), ef
        if pool:
            return mix_ppermute_pool(half, w, self.pool, g), ef
        if isinstance(w, ScheduleArrays):
            return mix_arrays_sharded(half, w, g), ef
        return mix_dense_sharded(half, w, g), ef

    def step_(self, params: Params, opt, batch: dict, operand, gossip: bool,
              grads: Params, delays: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """One step on ``params`` / ``opt`` in place (``grads``: scratch
        buffers); returns ``{"loss": the mean over nodes, <probe>: ...}``
        (float32 0-d tensors)."""
        carry = opt if _is_carry_dict(opt) else {}
        if self.compressor is not None and "ef" not in carry:
            raise ValueError("compressed mixing carries its error-feedback memory in the opt "
                             "state: pass opt_state including an 'ef' entry (build it with "
                             "TrainSetup.init_opt_state)")
        if self.staleness is not None and "stale" not in carry:
            raise ValueError("bounded-delay mixing carries its sender-side ring in the opt "
                             "state: pass opt_state including a 'stale' entry (build it with "
                             "TrainSetup.init_opt_state)")
        losses = self.grads_(params, batch, grads)
        m = opt.get("m") if _is_carry_dict(opt) else opt
        half, new_m = _sgd_update(params, grads, m, self.lr, self.momentum)
        new_ef = None
        if self.ranks:
            if gossip:
                half, new_ef = self.mix_rank(half, opt, operand, delays)
        elif self.mode == "dsgd" and gossip:
            half, new_ef = self.mix(half, opt, operand, delays)
        _copy_into(params, half)
        del half
        if self.momentum > 0.0:
            _copy_into(m, new_m)
        if new_ef is not None:
            _copy_into(opt["ef"], new_ef)
        if _is_carry_dict(opt) and "step" in opt:
            opt["step"].add_(1)
        if not self.ranks:
            out = {"loss": losses.mean()}
            if self.probes is not None and self.probes.consensus:
                out["consensus"] = spread_sq_stacked(params)
            if self.probes is not None and self.probes.grad_dev:
                out["grad_dev"] = spread_sq_stacked(grads) / self.n_nodes
            return out
        out = {"loss": self.layout.mean_loss(losses) if self.layout is not None
               else _psum(losses, self.group) / self.n_nodes}
        if self.probes is not None and self.probes.consensus:
            out["consensus"] = _spread_sq(params, self.group, self.layout)
        if self.probes is not None and self.probes.grad_dev:
            out["grad_dev"] = _spread_sq(grads, self.group, self.layout) / self.n_nodes
        return out

    def gossip_at(self, step: int) -> bool:
        """Whether step ``step`` mixes: dsgd on the multiples of
        ``gossip_every``; dsgd_pod every step (the reference's pods mix
        at every step)."""
        return self.mode == "dsgd_pod" or (self.mode == "dsgd" and step % self.gossip_every == 0)

    def phase(self, opt) -> int:
        """The step counter modulo ``gossip_every``, read on the host."""
        if self.gossip_every == 1:
            return 0
        if not (_is_carry_dict(opt) and "step" in opt):
            raise ValueError(
                "gossip_every > 1 needs a step counter: pass "
                "opt_state={'step': torch.zeros((), dtype=torch.int32), 'm': ...} "
                "(TrainSetup.init_opt_state)")
        return int(opt["step"]) % self.gossip_every


@dataclasses.dataclass
class _RolloutBody(Body):
    batch: dict | None = None
    outputs: dict | None = None


def _stale_inputs(w_stack, delays, device: torch.device) -> dict:
    """A staleness step's per-step operands as body inputs: the stacked
    gammas (and perms), the (k, n) delays."""
    if isinstance(w_stack, ScheduleArrays):
        out = {_GAMMAS: torch.as_tensor(w_stack.gammas, dtype=torch.float32, device=device),
               _PERMS: torch.as_tensor(w_stack.perms, dtype=torch.int32, device=device)}
    else:
        out = {_GAMMAS: torch.as_tensor(w_stack, dtype=torch.float32, device=device)}
    out[_DELAYS] = torch.as_tensor(delays, device=device).to(torch.int32)
    return out


class _Rollout:
    """``multi_step(params, opt_state, batches[, mix_w[, delays]]) ->
    (params, opt_state, losses)`` over static carries, as captured
    (``"scan"``) or eager (``"loop"``) bodies of at most
    ``MAX_GRAPH_STEPS`` steps.

    The given parameters, opt state and mixing operand are copied into
    the static carries at each call (a swap is a ``copy_``); the results
    returned are copies of the carries. ``n_traces`` counts the bodies'
    captures (``"loop"``: the distinct bodies, each counted once)."""

    def __init__(self, setup: "TrainSetup", captured: bool, retrace_guard=None):
        self.setup = setup
        self.captured = captured
        core = setup._core
        self._graphs = GraphRunner("run_segments.multi_step", core.device,
                                   retrace_guard=retrace_guard,
                                   fallback=" (run with rollout='loop')")
        self._bodies: dict[tuple, _RolloutBody] = {}
        self._seen: set = set()
        self.params: Params | None = None
        self.opt = None
        self.grads: Params | None = None
        self._operands: dict[tuple, Any] = {}

    @property
    def n_traces(self) -> int:
        return self._graphs.n_traces

    def _bind(self, params: Params, opt) -> None:
        if self.params is None:
            self.params = _clone(params)
            self.opt = _clone(opt)
            self.grads = {k: torch.empty_like(v) for k, v in self.params.items()}
            return
        _copy_into(self.params, params)
        _copy_into(self.opt, opt)

    def _operand(self, mix):
        """The static operand of ``mix``'s kind and shape, ``mix`` copied in."""
        if mix is None:
            return None
        value = _static_operand(mix, self.setup._core.device,
                                pool_gammas=self.setup.sharded_transport == "pool")
        key = _operand_key(value)
        static = self._operands.get(key)
        if static is None:
            static = self._operands[key] = (
                ScheduleArrays(value.gammas.clone(), value.perms.clone())
                if isinstance(value, ScheduleArrays) else value.clone())
        elif isinstance(value, ScheduleArrays):
            if value.perms.shape != static.perms.shape:
                raise ValueError(f"schedule swap: perms {tuple(value.perms.shape)} do not "
                                 f"match the run's {tuple(static.perms.shape)}")
            static.gammas.copy_(value.gammas)
            static.perms.copy_(value.perms)
        else:
            if value.shape != static.shape:
                raise ValueError(f"W swap: {tuple(value.shape)} against {tuple(static.shape)}")
            static.copy_(value)
        return static

    def _body(self, k: int, batch: dict, operand, phase: int) -> _RolloutBody:
        shapes = tuple((name, tuple(v.shape[1:]), v.dtype) for name, v in sorted(batch.items()))
        key = (k, shapes, _operand_key(operand), phase)
        body = self._bodies.get(key)
        if body is not None:
            return body
        core = self.setup._core
        inputs = {name: torch.empty((k,) + tuple(v.shape[1:]), dtype=v.dtype,
                                    device=core.device) for name, v in batch.items()}
        outputs = {name: torch.empty((k,), dtype=torch.float32, device=core.device)
                   for name in core.outputs}
        pattern = [core.gossip_at(phase + j) for j in range(k)]
        model_keys = [name for name in inputs if not name.startswith("__")]

        def fn() -> None:
            for j in range(k):
                op, delays = operand, None
                if _DELAYS in inputs:
                    op = (ScheduleArrays(inputs[_GAMMAS][j], inputs[_PERMS][j])
                          if _PERMS in inputs else inputs[_GAMMAS][j])
                    delays = inputs[_DELAYS][j]
                out = core.step_(self.params, self.opt, {name: inputs[name][j]
                                                         for name in model_keys},
                                 op, pattern[j], self.grads, delays)
                for name, v in out.items():
                    outputs[name][j] = v

        body = self._bodies[key] = _RolloutBody(fn, batch=inputs, outputs=outputs)
        return body

    def _run(self, body: _RolloutBody) -> None:
        if self.captured:
            self._graphs.run(body, "train segment body")
            return
        if id(body) not in self._seen:
            self._seen.add(id(body))
            self._graphs.count()
        body.fn()

    def release(self) -> None:
        """Drop the bodies and their graphs (``graphs.release``): a
        restaged run's old multi-step."""
        release(self._bodies)

    def __call__(self, params: Params, opt_state, batches: dict, *mix_w):
        self.setup._check_online_args(mix_w)
        self._bind(params, opt_state)
        losses = self.run(batches, *mix_w)
        return _clone(self.params), _clone(self.opt), losses

    def run(self, batches: dict, *mix_w):
        """The steps of ``batches`` on the bound carries (``_bind``), in
        place: their loss series (with probes, the dict of series)."""
        setup = self.setup
        setup._check_online_args(mix_w)
        core = setup._core
        batches = {name: torch.as_tensor(v, device=core.device) for name, v in batches.items()}
        operand = None
        if setup.staleness is not None and mix_w:
            batches.update(_stale_inputs(mix_w[0], mix_w[1], core.device))
        elif mix_w:
            operand = self._operand(mix_w[0])
        phase = core.phase(self.opt)
        steps = _leading(batches)
        out, t = {name: [] for name in core.outputs}, 0
        for k in chunks(steps):
            body = self._body(k, batches, operand, (phase + t) % core.gossip_every)
            for name, v in body.batch.items():
                v.copy_(batches[name][t:t + k])
            self._run(body)
            for name, v in body.outputs.items():
                out[name].append(v.clone())
            t += k
        series = {name: torch.cat(v) if v else torch.zeros((0,), device=core.device)
                  for name, v in out.items()}
        return series if core.probes is not None else series["loss"]


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _checkpoint_leaf(t: torch.Tensor) -> torch.Tensor:
    """A checkpointable view: bfloat16 by its bits (numpy has no bfloat16)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _mix_tree(mix):
    return {"gammas": mix.gammas, "perms": mix.perms} if isinstance(mix, ScheduleArrays) \
        else mix


def _checkpoint_tree(params: Params, opt, mix) -> dict:
    def view(tree):
        if isinstance(tree, dict):
            return {k: view(v) for k, v in tree.items() if v is not None}
        return _checkpoint_leaf(tree)

    tree = {"params": view(params)}
    if opt is not None:
        tree["opt"] = view(opt)
    tree["mix"] = _mix_tree(mix)
    return tree


def _restore_into(like, values, device: torch.device):
    """Numpy ``values`` (in ``like``'s structure) as tensors of ``like``'s
    dtypes on ``device``."""
    if isinstance(like, dict):
        return {k: _restore_into(like[k], values[k], device) if like[k] is not None else None
                for k in like}
    t = torch.from_numpy(np.array(values)).to(device)
    return t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t.to(like.dtype)


def _restore_mix(mix, values, device: torch.device):
    if isinstance(mix, ScheduleArrays):
        return ScheduleArrays(*(torch.from_numpy(np.array(values[k])).to(device)
                                for k in ("gammas", "perms")))
    return torch.from_numpy(np.array(values)).to(device)


def _rank_tree(params: Params, opt, node, rep) -> dict:
    """``{params, opt}`` with ``node(leaf, name, offset)`` applied to every
    per-node leaf (the parameters, momentum, EF memory, stale ring; named
    as its parameter, ``offset`` the ring's depth axis before the
    parameter's) and ``rep`` to the replicated ones (the step counter, the
    ring's head)."""
    def per_node(tree, offset=0):
        return {k: node(v, k, offset) for k, v in tree.items()}

    tree = {"params": per_node(params)}
    if opt is None:
        return tree
    if not _is_carry_dict(opt):
        tree["opt"] = per_node(opt)
        return tree
    tree["opt"] = {}
    for k, v in opt.items():
        if k == "step":
            tree["opt"][k] = rep(v)
        elif k == "stale":
            tree["opt"][k] = {"buf": per_node(v["buf"], 1), "head": rep(v["head"])}
        else:
            tree["opt"][k] = per_node(v)
    return tree


class _Shape:
    """A restore template leaf: only its shape is read (``row``: a
    per-node leaf, of which a rank keeps its own row -- on a mesh its
    block of the row: ``name`` and ``offset`` say which)."""

    def __init__(self, shape, row: bool = False, name: str | None = None, offset: int = 0):
        self.shape = tuple(shape)
        self.row = row
        self.name, self.offset = name, offset


def _gather_leaf(x: torch.Tensor, group) -> torch.Tensor | None:
    """Every rank's ``x`` stacked on the group's first rank, as a
    checkpointable view (None on the other ranks)."""
    out = _gather_first(x, group)
    return None if out is None else _checkpoint_leaf(out)


def _gather_mesh_leaf(layout: MeshLayout, x: torch.Tensor, name: str, offset: int):
    """A mesh leaf whole and stacked over nodes on the mesh's first rank,
    as a checkpointable view (None on the other ranks): gathered over
    every other mesh dimension first (``model``, then ``data``)."""
    out = layout.full_leaf(x, name, offset)
    return None if out is None else _checkpoint_leaf(out)


@dataclasses.dataclass
class TrainSetup:
    """The LM trainer of one ``(cfg, mode)``: the step, its rollouts and
    the segmented online rollout.

    ``train_step(params, opt_state, batch[, mix_w[, delays]]) -> (params,
    opt_state, loss)`` is one eager step on copies (the inputs are left as
    they were); ``params`` is a dict of tensors named as the model's
    parameters, with a leading node axis on stacked nodes (``batch``
    leaves ``(n, per_node, ...)``), none in ``fsdp`` (``(batch, ...)``)
    and one node per rank (``(per_node, ...)``); on a mesh a rank's
    blocks of the leaves (``param_specs``) and its slice of the batch
    (``local_batch``); ``loss`` is the mean over nodes, float32 (with
    ``probes``, the dict ``{"loss", <probe>...}``).
    ``grad_fn(params, batch) -> (losses, grads)`` gives every node's loss
    and gradient without a step. ``init_params(seed)`` draws one model
    from ``seed`` (``registry.init_model``) and, stacked, copies it to
    every node (Algorithm 1: one init; every rank draws the same).
    """

    train_step: Callable
    init_params: Callable
    grad_fn: Callable
    mode: str
    n_nodes: int
    online_w: bool = False
    sharded_transport: str | None = None
    pool: PermPool | None = None
    comm_bytes_per_step: int | None = None
    compression: Compressor | None = None
    staleness: StragglerPolicy | None = None
    probes: HealthProbes | None = None
    group: Any = None
    mesh: Any = None
    _core: _Step | None = dataclasses.field(default=None, repr=False, compare=False)
    _layout: MeshLayout | None = dataclasses.field(default=None, repr=False, compare=False)
    _init_opt_state: Callable | None = dataclasses.field(default=None, repr=False,
                                                         compare=False)
    _rebuild: Callable | None = dataclasses.field(default=None, repr=False, compare=False)

    def init_opt_state(self, params: Params):
        """The opt state the step carries, in the reference's convention:
        None when nothing is carried, the bare momentum tree for momentum
        alone, else a dict with ``"step"`` (a 0-d int32 counter, for
        ``gossip_every > 1``), ``"m"`` (the momentum), ``"ef"`` (the EF
        memory, float32) and ``"stale"`` (``{"buf": the ring, leaves
        (depth, ...) a rank, (n, depth, ...) stacked, float32 -- bfloat16
        where it holds bf16 values exactly, ``core.mixing.stale_ring_dtype``
        --, "head": a 0-d int64}``). The EF memory and the ring are
        broadcast views until a step copies them into its own tensors."""
        if self._init_opt_state is None:
            raise ValueError("init_opt_state needs a setup built by make_train_setup")
        return self._init_opt_state(params)

    def multi_step_fn(self, rollout: str = "scan", *, retrace_guard=None) -> _Rollout:
        """``multi_step(params, opt_state, batches[, mix_w]) -> (params,
        opt_state, losses)``: every ``batches`` leaf carries a leading
        time axis ``(k, ...)``; ``losses`` is ``(k,)`` (with ``probes``, a
        dict of ``(k,)`` series). With ``staleness`` the call is
        ``multi_step(params, opt_state, batches, mix_stack, delays)``: the
        per-step operands stacked on ``k`` (a ``ScheduleArrays`` of
        ``(k, L)`` gammas and ``(k, L, n)`` perms, or ``(k, capacity)``
        pool gammas) and ``(k, n)`` delays. ``"scan"`` captures its
        bodies as CUDA graphs (on the CPU it runs them eagerly, counting
        captures as the card would; refused on a gloo group, whose host
        work a graph cannot hold), ``"loop"`` runs the same bodies
        eagerly. The function keeps its bodies and static carries across
        calls; ``n_traces`` counts its captures."""
        if rollout not in ("scan", "loop"):
            raise ValueError(f"unknown rollout {rollout!r}")
        ranks = self.group is not None or self.mesh is not None
        if rollout == "scan" and ranks and group_backend(self.group) != "nccl":
            raise ValueError(
                f"rollout='scan' captures the step's collectives in CUDA graphs, and the "
                f"{group_backend(self.group)!r} backend's cannot be captured; use "
                f"rollout='loop' or an nccl group")
        return _Rollout(self, rollout == "scan", retrace_guard)

    @property
    def expert_loads(self) -> dict[str, torch.Tensor]:
        """The held-expert MoE layers' load counters, by module name
        (``layers.<i>.mlp.load``): (held,) int32 device tensors, the choices
        each held expert received summed over every node and step since
        the setup was built (empty without held experts)."""
        return {k[len("model."):]: v for k, v in self._core.buffers.items()
                if k.endswith(".load")}

    @property
    def param_specs(self) -> dict | None:
        """On a mesh, every parameter's spec at rest
        (``sharding.make_param_specs``: ``node_axis=None``; ``fsdp_axis``
        ``"data"`` in fsdp and dsgd_pod); None otherwise."""
        return None if self._layout is None else self._layout.specs

    def local_batch(self, batch: dict, lead: int = 0) -> dict:
        """On a mesh, this rank's slice of a batch in the reference's layout
        (after ``lead`` leading axes, e.g. a time axis; see
        ``MeshLayout.local_batch``): dsgd its node's row, dsgd_pod its
        pod's row split over ``data``, fsdp its slice of ``(batch, ...)``
        split over every mesh dimension."""
        if self._layout is None:
            raise ValueError("local_batch needs a setup built with mesh=")
        return self._layout.local_batch(batch, lead)

    def _check_online_args(self, mix_w: tuple) -> None:
        if self.online_w and self.staleness is not None:
            if len(mix_w) != 2:
                raise TypeError("staleness setup: call multi_step(params, opt_state, batches, "
                                "mix_stack, delays)")
            return
        if self.online_w and len(mix_w) != 1:
            raise TypeError("online_w setup: call multi_step(params, opt_state, batches, mix_w)")
        if not self.online_w and mix_w:
            raise TypeError("this setup was built without online_w; no mix_w argument expected")

    # -- checkpoints ---------------------------------------------------------

    def _save(self, directory: str, t: int, params: Params, opt, mix) -> None:
        if self.group is None and self._layout is None:
            save_checkpoint(directory, t, _checkpoint_tree(params, opt, mix),
                            metadata={"t": int(t)})
            return
        # one node per rank: rank 0 writes the stacked layout (node axis
        # first), each per-node leaf gathered to it when the writer reaches
        # it and dropped before the next, so one leaf's (n, P_leaf) is held;
        # on a mesh each leaf is first gathered whole over its other
        # dimensions (every rank of them takes part)
        layout = self._layout
        if layout is None:
            tree = _rank_tree(params, opt, lambda x, *_: lambda: _gather_leaf(x, self.group),
                              _checkpoint_leaf)
            writer = axis_index(self.group) == 0
        else:
            tree = _rank_tree(params, opt, lambda x, name, off: lambda: _gather_mesh_leaf(
                layout, x, name, off), _checkpoint_leaf)
            writer = layout.writes_node_row() and layout.node == 0
        tree["mix"] = _mix_tree(mix)
        if writer:
            save_checkpoint(directory, t, tree, metadata={"t": int(t)})
        else:
            for leaf in tree_leaves(tree):
                if callable(leaf):
                    leaf()
        import torch.distributed as dist

        dist.barrier(group=self.group if layout is None else None)

    def _restore(self, directory: str, step: int, params: Params, opt, mix):
        device, layout = self._core.device, self._layout
        if self.group is None and layout is None:
            like = _checkpoint_tree(params, opt, mix)
            tree, _ = restore_checkpoint(directory, step, like)
            return (_restore_into(params, tree["params"], device),
                    _restore_into(opt, tree["opt"], device) if opt is not None else None,
                    _restore_mix(mix, tree["mix"], device))
        # every rank reads the stacked layout leaf by leaf, keeping its own
        # row (on a mesh: its block of the row)
        n = self.n_nodes
        if layout is None:
            i = axis_index(self.group)
            like = _rank_tree(params, opt, lambda x, *_: _Shape((n,) + tuple(x.shape), row=True),
                              lambda x: _Shape(x.shape))

            def select(a, tmpl):
                return a[i].copy() if getattr(tmpl, "row", False) else a
        else:
            i = layout.node
            like = _rank_tree(params, opt, lambda x, name, off: _Shape(
                (n,) + layout.full_shape(name, x.shape[:off]), row=True, name=name, offset=off),
                lambda x: _Shape(x.shape))

            def select(a, tmpl):
                if not getattr(tmpl, "row", False):
                    return a
                row = torch.from_numpy(np.ascontiguousarray(a[i]))
                return layout.shard(row, tmpl.name, tmpl.offset).numpy()
        like["mix"] = _mix_tree(mix)
        tree, _ = restore_checkpoint(directory, step, like, select=select)
        params = _restore_into(params, tree["params"], device)
        if opt is not None:
            opt = _restore_into(opt, tree["opt"], device)
        return params, opt, _restore_mix(mix, tree["mix"], device)

    # -- the segmented online rollout -----------------------------------------

    def _as_mix_operand(self, update, pool: PermPool | None):
        """A hook's return or the initial mix as the step's operand (the
        reference's ``_as_mix_operand``): a ``PoolSwap``'s gammas; on the
        pool transport (capacity,) gammas; on the all-gather transport
        pool-coordinate gammas as their ``ScheduleArrays`` twin
        (``pool.arrays_for``, bitwise the pool's mix)."""
        device = self._core.device
        if isinstance(update, PoolSwap):
            update = update.gammas
        if isinstance(update, ScheduleArrays):
            return _static_operand(update, device)
        arr = update.detach().cpu().numpy() if isinstance(update, torch.Tensor) else update
        arr = np.asarray(arr, np.float32)
        if self.sharded_transport == "pool":
            if arr.shape != (self.pool.capacity,):
                raise ValueError(f"pool transport expects ({self.pool.capacity},) gammas, "
                                 f"got {arr.shape}")
            return torch.as_tensor(arr, device=device)
        if pool is not None and arr.ndim == 1:
            if arr.shape != (pool.capacity,):
                raise ValueError(f"pool-coordinate gammas must be ({pool.capacity},), "
                                 f"got {arr.shape}")
            return pool.arrays_for(arr, device=device)
        return _static_operand(arr, device)

    def _stale_stream(self, base, d_seg: np.ndarray, pool: PermPool | None):
        """A segment's delay slice resolved against the policy into its
        per-step operand stack and effective delays (host side)."""
        if isinstance(base, ScheduleArrays):
            g, p, eff = straggler_stream(self.staleness, base, d_seg)
            return ScheduleArrays(gammas=g, perms=p), eff
        if base.ndim == 1:
            return straggler_pool_stream(self.staleness, base, pool, d_seg)
        raise ValueError("staleness needs a ScheduleArrays or pool-gamma mixing operand: a dense "
                         "(n, n) W has no per-sender payload to delay (decompose it with "
                         "schedule_from_matrix)")

    def run_segments(
        self,
        params: Params,
        opt_state,
        batches: dict,
        mix,
        *,
        segment_len: int,
        on_segment: Callable | None = None,
        rollout: str = "scan",
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        resume: bool = False,
        stop_after_segments: int | None = None,
        delays=None,
        quarantine=None,
        tracer: Tracer | None = None,
        retrace_guard=None,
    ) -> dict:
        """Segmented online rollout with hot swaps at the boundaries, as the
        reference's: ``segment_len``-step slices of ``batches`` (leaves
        ``(steps, ...)``) through one multi-step; ``on_segment(t)`` after
        every segment but the last may return None, a ``ScheduleArrays``,
        an ``(n, n)`` W or a ``PoolSwap`` (an in-pool swap is a value
        copy; a restage on the pool transport rebuilds the step around the
        new pool, counted in ``recompiles``; on the all-gather transport it
        runs as the pool's ``ScheduleArrays`` twin), copied into the
        bodies' static operand (no capture added).
        With ``checkpoint_dir``, ``{params, opt, mix}`` is saved every
        ``checkpoint_every``-th boundary after the hook (and at the end and
        at an early stop); ``resume`` restores the newest and continues,
        bitwise the uninterrupted run; ``stop_after_segments`` ends the
        run early (``stopped_at``). ``delays`` (a staleness setup's raw
        ``(steps, n)`` trace, default zeros) is resolved per segment
        against the policy; ``quarantine`` (an object with ``mask()`` and
        ``summary()``) charges the meter's quarantined bytes; with
        ``probes`` the per-step series come back under ``"health"``. The
        carries stay the multi-step's own between segments; the results
        are copied out at the end. ``tracer`` records ``segment.rollout`` /
        ``segment.restage`` / ``segment.checkpoint`` spans,
        ``retrace_guard`` the captures under ``"run_segments.multi_step"``.

        Returns ``{"params", "opt_state", "losses", "n_traces", "swaps",
        "recompiles", "segment_s", "comm", "setup", "mix", "resumed_from",
        "stopped_at"}`` (and ``"quarantine"``, ``"health"``); ``setup`` and
        ``mix`` are the live ones after a restage; ``comm`` is the
        reference's float32 accounting (``make_train_setup``), not the
        bytes the port's wire moves.
        """
        if not self.online_w:
            raise ValueError("run_segments needs an online_w=True setup")
        if segment_len < 1:
            raise ValueError(f"segment_len must be >= 1, got {segment_len}")
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        tracer = _NULL_TRACER if tracer is None else tracer
        steps = _leading(batches)
        setup = self
        if self.staleness is None:
            if delays is not None:
                raise ValueError("delays given but this setup has no staleness policy: build "
                                 "with make_train_setup(staleness=StragglerPolicy(...))")
        else:
            delays = (np.zeros((steps, self.n_nodes), np.int64) if delays is None
                      else np.asarray(delays, np.int64))
            if delays.shape != (steps, self.n_nodes):
                raise ValueError(f"delays must be ({steps}, {self.n_nodes}), got {delays.shape}")
            if delays.size and delays.min() < 0:
                raise ValueError("delays must be non-negative")
        msj = setup.multi_step_fn(rollout, retrace_guard=retrace_guard)
        traces_before = 0
        pool = setup.pool
        mix = setup._as_mix_operand(mix, pool)
        meter = CommMeter(per_step_bytes=setup.comm_bytes_per_step or 0)
        names = setup.probes.names() if setup.probes is not None else ()
        health: dict[str, list] = {name: [] for name in names}
        losses, swaps, segment_s = [], [], []
        t0, resumed_from, stopped_at, recompiles = 0, None, None, 0
        if checkpoint_dir is not None and resume:
            last = latest_step(checkpoint_dir)
            if last is not None:
                params, opt_state, mix = setup._restore(checkpoint_dir, last, params,
                                                        opt_state, mix)
                t0 = resumed_from = int(last)

        # the carries stay the multi-step's own between segments (no copy a
        # segment); the results are copied out at the end
        msj._bind(params, opt_state)

        def save(t: int) -> None:
            with tracer.span("segment.checkpoint", t=int(t)):
                setup._save(checkpoint_dir, t, msj.params, msj.opt, mix)

        seg_idx = 0
        while t0 < steps:
            k = min(segment_len, steps - t0)
            seg = {name: v[t0:t0 + k] for name, v in batches.items()}
            tic = time.perf_counter()
            with tracer.span("segment.rollout", t0=t0, k=k):
                if setup.staleness is not None:
                    d_seg = delays[t0:t0 + k]
                    w_stack, eff = setup._stale_stream(mix, d_seg, pool)
                    loss = msj.run(seg, w_stack, eff)
                else:
                    loss = msj.run(seg, mix)
                loss = {name: v.cpu().numpy() for name, v in loss.items()} if names \
                    else loss.cpu().numpy()
            segment_s.append(time.perf_counter() - tic)
            q_share = 0.0
            if quarantine is not None:
                h, n = int(np.asarray(quarantine.mask(), bool).sum()), setup.n_nodes
                q_share = 1.0 - (n - h) * (n - h - 1) / (n * (n - 1)) if n > 1 and h > 0 \
                    else 0.0
            if setup.staleness is not None:
                fates = [staleness_transfer_fracs(d_seg[j], setup.staleness.tau_max,
                                                  setup.staleness.mode) for j in range(k)]
                on_time = float(np.mean([f[0] for f in fates]))
                deferred = float(np.mean([f[1] for f in fates]))
                meter.tick(k, delivered_frac=on_time + deferred, deferred_frac=deferred,
                           quarantined_frac=(on_time + deferred) * q_share)
            else:
                meter.tick(k, quarantined_frac=q_share)
            if names:
                losses.append(loss["loss"])
                for name in names:
                    health[name].append(loss[name])
            else:
                losses.append(loss)
            t0 += k
            seg_idx += 1
            if on_segment is not None and t0 < steps:  # no hook after the final segment
                update = on_segment(t0 - 1)
                if update is not None:
                    swaps.append(t0 - 1)
                    if isinstance(update, PoolSwap) and update.restaged:
                        pool = update.pool
                        if setup.sharded_transport == "pool":
                            # the new atoms are not staged: rebuild the step
                            # around the new pool (the one counted restage)
                            with tracer.span("segment.restage", t=t0 - 1):
                                traces_before += msj.n_traces
                                setup = setup._rebuild(pool)
                                old, msj = msj, setup.multi_step_fn(
                                    rollout, retrace_guard=retrace_guard)
                                msj._bind(old.params, old.opt)
                                old.release()
                                del old
                            recompiles += 1
                            meter.set_rate(setup.comm_bytes_per_step or 0, step=t0)
                    mix = setup._as_mix_operand(update, pool)
            if checkpoint_dir is not None and (seg_idx % checkpoint_every == 0 or t0 >= steps):
                save(t0)
            if stop_after_segments is not None and seg_idx >= stop_after_segments and t0 < steps:
                if checkpoint_dir is not None and seg_idx % checkpoint_every != 0:
                    save(t0)  # the crash drill must leave a resumable state
                stopped_at = t0
                break
        out = {
            "params": _clone(msj.params),
            "opt_state": _clone(msj.opt),
            "losses": np.concatenate(losses) if losses else np.zeros((0,)),
            "n_traces": traces_before + msj.n_traces,
            "swaps": swaps,
            "recompiles": recompiles,
            "segment_s": segment_s,
            "comm": meter.summary(),
            "setup": setup,
            "mix": mix,
            "resumed_from": resumed_from,
            "stopped_at": stopped_at,
        }
        if quarantine is not None:
            out["quarantine"] = quarantine.summary()
        if names:
            out["health"] = {name: np.concatenate(v) if v else np.zeros((0,))
                             for name, v in health.items()}
        return out


def _check_robustness(mode: str, online_w: bool, gossip_every: int, compressor, staleness,
                      probes) -> None:
    """The reference's checks of ``compression`` / ``staleness`` /
    ``probes`` over ranks, its mode refusals in its words."""
    if probes is not None:
        if not isinstance(probes, HealthProbes):
            raise TypeError(f"probes must be a HealthProbes, got {type(probes).__name__}")
        if probes.tau_bar:
            raise ValueError(
                "the tau_bar probe needs the in-carry ScheduleArrays of the simulator drivers "
                "(run_mean_estimation / run_classification); the rank transports never carry "
                "W's coefficients")
        if mode != "dsgd":
            raise ValueError(
                f"health probes are incompatible with mode={mode!r}: they are collectives over "
                "the manual dsgd node axis (fsdp has one global model -- consensus is "
                "identically 0; dsgd_pod mixes by GSPMD einsum)")
        if not online_w:
            raise ValueError("health probes ride the online step: build with online_w=True")
    if staleness is not None:
        if not isinstance(staleness, StragglerPolicy):
            raise TypeError(f"staleness must be a StragglerPolicy, got {type(staleness)}")
        if mode != "dsgd":
            raise ValueError(
                f"staleness is incompatible with mode={mode!r}: the bounded-delay ring is "
                "per-NODE sender state, which only the dsgd shard_map transports carry (fsdp "
                "all-reduces in-network; dsgd_pod mixes by GSPMD einsum)")
        if not online_w:
            raise ValueError("staleness rides the online transports: build with online_w=True")
        if gossip_every > 1:
            raise ValueError(
                f"staleness is incompatible with gossip_every={gossip_every}: off-steps would "
                "push no ring slot while delays keep counting pushes; run bounded-delay gossip "
                "with gossip_every=1")
    if compressor is not None:
        if mode == "fsdp":
            raise ValueError(
                f"compression={compressor.label!r} is incompatible with mode='fsdp': the "
                "C-PSGD baseline mixes by in-network all-reduce, so there is no per-edge "
                "gossip payload for a wire format to compress")
        if mode == "dsgd_pod":
            raise ValueError(
                f"compression={compressor.label!r} is incompatible with mode='dsgd_pod': "
                "cross-pod mixing is a GSPMD einsum with no EF memory carry; use mode='dsgd'")
        if not online_w:
            raise ValueError("compression rides the online transports: build with online_w=True")


def _kernel_refusal(cfg: ModelConfig, device: torch.device) -> str | None:
    """Why ``impl="kernel"`` cannot train ``cfg`` on ``device``, or None."""
    if "rglru" in cfg.layer_pattern:
        return "the RG-LRU scan kernel has no backward"
    if device.type == "cuda" and dtype_of(cfg) != torch.bfloat16:
        return f"the flash-attention kernel's backward takes bfloat16 only, not {cfg.dtype}"
    return None


def _train_impl(cfg: ModelConfig, device: torch.device, impl: str | None) -> str:
    """``impl`` as ``make_train_setup`` runs it: None is ``"kernel"`` on a
    CUDA device where ``cfg`` can train through the kernels, else
    ``"plain"``; ``"kernel"`` where it cannot raises."""
    if impl is None:
        return "kernel" if device.type == "cuda" and _kernel_refusal(cfg, device) is None \
            else "plain"
    reason = _kernel_refusal(cfg, device) if impl == "kernel" else None
    if reason is not None:
        raise ValueError(f"impl='kernel' cannot train {cfg.name} on {device.type}: {reason} "
                         "(no backward kernel); use impl='plain'")
    return impl


def make_train_setup(
    cfg: ModelConfig,
    *,
    n_nodes: int = 1,
    mode: str = "dsgd",
    schedule: BirkhoffSchedule | None = None,
    lr: float = 1e-3,
    momentum: float = 0.0,
    impl: str | None = None,
    grad_accum: int = 1,
    gossip_every: int = 1,
    online_w: bool = False,
    sharded_transport: str = "auto",
    pool: PermPool | None = None,
    compression=None,
    staleness: StragglerPolicy | None = None,
    probes: HealthProbes | None = None,
    group=None,
    mesh=None,
    device: torch.device | str | None = None,
    remat: bool = False,
) -> TrainSetup:
    """The train step for ``(cfg, mode)`` on ``device`` (None = CUDA): the
    reference's ``make_train_setup`` with ``mesh`` replaced by ``n_nodes``
    stacked nodes (ignored in ``fsdp`` mode, which has one global model)
    or by ``group``, a ``torch.distributed`` process group (e.g.
    ``torch.distributed.group.WORLD``) whose every rank is one node.

    ``schedule=None`` in dsgd mode means complete-graph mixing;
    ``online_w=True`` makes the mixing operand a trailing argument of the
    step: a dense (n, n) W or a ``ScheduleArrays`` on the ``"allgather"``
    transport, the pool's (capacity,) gammas on ``"pool"`` (``pool=`` a
    ``PermPool``); ``"auto"`` is ``"allgather"`` without a pool, else over
    ranks the measured table's pick (``autotune_sharded_transport``, a
    lookup) or its closed form, stacked the closed form.
    ``grad_accum > 1`` splits each node's batch into microbatches and
    takes the mean of their gradients (float32 accumulation);
    ``gossip_every = k > 1`` mixes only on steps whose counter (carried in
    the opt state, see ``init_opt_state``) is a multiple of k. Stacked, the
    mix runs in the gossip kernels on the card and in the reference's
    numerics (sums in the leaf dtype) on the CPU. In every layout
    ``compression`` (a ``Compressor`` or a spec string) makes the online
    transports EF-compressed, ``staleness`` (a ``StragglerPolicy``)
    bounded-delay, ``probes`` (a ``HealthProbes``) adds the per-step
    ``consensus`` / ``grad_dev`` outputs, each as the reference checks
    them; stacked, these and the pool's gammas mix in the rank
    transports' float32 numerics (the module docstring). ``remat=True`` recomputes each layer's and each loss chunk's
    activations in the backward pass (the reference's ``remat``, on there):
    the same gradients bitwise, one block's activations held at a time, at
    the cost of a second forward; for ranks that share a card.

    ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh`` named as the
    reference's axes, e.g. ``train.sharding.make_mesh((2, 2), ("data",
    "model"))``) is the reference's mesh (``train/mesh_layout.py``):
    ``dsgd`` on ``(data, model)`` (a node a ``data`` coordinate, its
    replica split over ``model``: tensor parallelism), ``fsdp`` on
    ``(data, model)`` (one global model split over every rank at rest,
    the batch split over every rank), ``dsgd_pod`` on ``(pod, data,
    model)`` (a node a pod; weights at rest split over ``data`` and
    ``model``, a pod's batch over ``data``; the pods mix by the dense W in
    float32: the schedule's, the complete graph's or ``online_w``'s).
    ``group=`` is the ``("data",)`` mesh with one rank a node. A rank's
    leaves are its blocks (``convert.lm_shard_from_numpy``), its batch its
    slice (``TrainSetup.local_batch``).

    ``comm_bytes_per_step`` (and ``run_segments``' ``"comm"`` meter) is
    the reference's accounting: ``mix_bytes_per_step`` of the transport
    with float32 payloads (the compressor's wire with ``compression``),
    as the tests hold it. It is not the port's wire: over ranks a
    bfloat16 leaf moves as bfloat16, so for a bfloat16 model a rank
    receives half of it; ``mixing.collective_bytes`` counts what a rank
    really receives.

    ``impl`` (None: resolved by the device and ``cfg``, the module
    docstring) picks the attention the step trains through.
    """
    if mesh is not None and group is not None:
        raise ValueError("pass mesh= or group=, not both (group= is a ('data',) mesh)")
    ranks = group is not None or mesh is not None
    if mode not in ("dsgd", "dsgd_pod", "fsdp"):
        raise ValueError(f"unknown mode {mode}")
    if mode == "dsgd_pod" and mesh is None:
        raise ValueError("dsgd_pod requires a 'pod' mesh axis: pass mesh= a (pod, data, model) "
                         "DeviceMesh")
    if mode == "fsdp" and group is not None:
        raise ValueError("fsdp over ranks takes mesh= a (data, model) DeviceMesh (group= is the "
                         "one-node-a-rank layout of dsgd)")
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    compressor = make_compressor(compression)
    _check_robustness(mode, online_w, gossip_every, compressor, staleness, probes)
    if sharded_transport not in ("auto", "allgather", "pool"):
        raise ValueError(f"unknown sharded_transport {sharded_transport!r}")
    if online_w and mode == "fsdp":
        raise ValueError("online_w needs a node axis (dsgd/dsgd_pod); fsdp has no W")
    if online_w and schedule is not None:
        raise ValueError("online_w and a static schedule are mutually exclusive -- pass the "
                         "initial W as the mix_w argument of the step instead")
    if pool is not None and not (online_w and mode == "dsgd"):
        raise ValueError("a PermPool requires online_w=True and mode='dsgd'")
    if sharded_transport == "pool" and pool is None:
        raise ValueError("sharded_transport='pool' requires a PermPool")
    if grad_accum < 1 or gossip_every < 1:
        raise ValueError(f"grad_accum and gossip_every must be >= 1, got {grad_accum}, "
                         f"{gossip_every}")
    device = resolve_device(device)
    impl = _train_impl(cfg, device, impl)
    meta = whisper.Whisper(cfg, "meta") if cfg.arch_type == "audio" else \
        transformer.LM(cfg, "meta")
    layout = None
    if mesh is not None:
        layout = MeshLayout(cfg, mesh, mode, {k: tuple(p.shape)
                                              for k, p in meta.named_parameters()})
        group = layout.node_group  # the nodes' group: data (dsgd), pod (dsgd_pod), none (fsdp)
        n = layout.n_nodes
        if n_nodes not in (1, n):
            raise ValueError(f"n_nodes={n_nodes} but the mesh has {n} nodes")
    elif ranks:
        n = axis_size(group)
        if n_nodes not in (1, n):
            raise ValueError(f"n_nodes={n_nodes} but the group has {n} ranks")
    else:
        n = n_nodes if mode == "dsgd" else 1
    if schedule is not None and schedule.n_nodes != n:
        raise ValueError(f"schedule has {schedule.n_nodes} nodes, the setup provides {n}")
    if pool is not None and pool.n_nodes != n:
        raise ValueError(f"pool is staged for {pool.n_nodes} nodes, the group provides {n}")
    if schedule is not None and not ranks:
        schedule.operands(device)  # made and checked once, before any capture

    p_total = sum(int(np.prod(p.shape)) for p in meta.parameters())
    resolved = comm = None
    if mode == "dsgd":
        if online_w:
            resolved = sharded_transport
            if sharded_transport == "auto":
                # stacked, both transports are one gossip_schedule launch on
                # the card (the pool's atoms or their ScheduleArrays twin):
                # the closed form on the reference's bytes decides
                resolved = "allgather" if pool is None else \
                    autotune_sharded_transport(n, pool.n_comm_slots, p_total, group=group,
                                               device=device) if ranks else \
                    preferred_sharded_transport(n, pool.n_comm_slots)
            pooled = resolved == "pool"
            comm = mix_bytes_per_step("pool" if pooled else "allgather", n_nodes=n,
                                      p_total=p_total,
                                      n_comm_atoms=pool.n_comm_slots if pooled else None,
                                      compression=compressor)
        elif schedule is not None:
            comm = mix_bytes_per_step("ppermute", n_nodes=n, p_total=p_total,
                                      n_comm_atoms=schedule.n_communication_atoms)
        else:
            comm = mix_bytes_per_step("allreduce", n_nodes=n, p_total=p_total)
    core = _Step(cfg, mode=mode, n_nodes=n, lr=lr, momentum=momentum, impl=impl,
                 grad_accum=grad_accum, gossip_every=gossip_every, online_w=online_w,
                 schedule=schedule, device=device, group=group, transport=resolved,
                 pool=pool, compressor=compressor, staleness=staleness, probes=probes,
                 remat=remat, layout=layout)

    def init_params(seed: int = 0) -> Params:
        model = registry.init_model(cfg, seed=seed, device=device)
        single = {name: p.detach() for name, p in model.named_parameters()}
        if layout is not None:
            return {name: layout.shard(p, name) for name, p in single.items()}
        if mode == "fsdp" or ranks:
            return single
        return {name: p[None].expand((n,) + tuple(p.shape)).clone() for name, p in single.items()}

    def grad_fn(params: Params, batch: dict):
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        losses = core.grads_(params, batch, grads)
        return losses, grads

    def train_step(params: Params, opt_state, batch: dict, *mix_w):
        setup._check_online_args(mix_w)
        params, opt_state = _clone(params), _clone(opt_state)
        operand, delays = None, None
        if mix_w:
            operand = _static_operand(mix_w[0], device, pool_gammas=resolved == "pool")
        if staleness is not None:
            delays = torch.as_tensor(mix_w[1], device=device).to(torch.int32)
        gossip = core.gossip_at(core.phase(opt_state))
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        out = core.step_(params, opt_state, batch, operand, gossip, grads, delays)
        return params, opt_state, out if probes is not None else out["loss"]

    def init_opt_state(params: Params):
        out: dict = {}
        if gossip_every > 1:
            out["step"] = torch.zeros((), dtype=torch.int32, device=device)
        if momentum > 0.0:
            out["m"] = {k: torch.zeros_like(v) for k, v in params.items()}
        # the EF memory and the ring start as broadcast views (zeros; every
        # slot the current parameters): the step copies them into its own
        # tensors, so the caller's copy costs no memory
        if compressor is not None:
            zero = torch.zeros((), dtype=torch.float32, device=device)
            out["ef"] = {k: zero.expand(v.shape) for k, v in params.items()}
        if staleness is not None:
            # leaves (depth, ...) a rank; stacked, node-first (n, depth, ...):
            # the reference's stacked layout (and every checkpoint's)
            depth, dtype = staleness.ring_depth, stale_ring_dtype(params, compressor)
            lead = 0 if ranks or mode != "dsgd" else 1
            out["stale"] = {
                "buf": {k: v.to(dtype).unsqueeze(lead).expand(
                    tuple(v.shape[:lead]) + (depth,) + tuple(v.shape[lead:]))
                        for k, v in params.items()},
                "head": torch.zeros((), dtype=torch.long, device=device)}
        if not out:
            return None
        if set(out) == {"m"}:
            return out["m"]
        return out

    def rebuild(new_pool: PermPool) -> TrainSetup:
        return make_train_setup(
            cfg, n_nodes=n_nodes, mode=mode, schedule=schedule, lr=lr, momentum=momentum,
            impl=impl, grad_accum=grad_accum, gossip_every=gossip_every, online_w=online_w,
            sharded_transport="pool", pool=new_pool, compression=compressor,
            staleness=staleness, probes=probes, group=None if mesh is not None else group,
            mesh=mesh, device=device, remat=remat)

    setup = TrainSetup(
        train_step=train_step, init_params=init_params, grad_fn=grad_fn, mode=mode,
        n_nodes=n, online_w=online_w, sharded_transport=resolved, pool=pool,
        comm_bytes_per_step=comm, compression=compressor, staleness=staleness, probes=probes,
        group=group, mesh=mesh, _core=core, _layout=layout, _init_opt_state=init_opt_state,
        _rebuild=rebuild,
    )
    if ranks:
        import torch.distributed as dist

        # every rank's first collective of each group together (NCCL's
        # batched point-to-point needs the group's communicator set up)
        for g in (layout.all_groups() if layout is not None else [group]):
            dist.barrier(group=g)
    return setup
