"""LM D-SGD training on one device: the reference's mesh trainer
(``repro/train/lm_trainer.py``) with the node axis stacked.

The reference runs one D-SGD node per index of its ``data`` mesh axis and
mixes with collectives. Here the ``n`` replicas are stacked on one card,
as the simulator stacks them (``train/trainer.py``): every parameter is a
tensor of shape ``(n, ...)``, named as ``LM.named_parameters()``
(``convert.lm_stacked_from_numpy`` carries the reference's
``init_params`` over), and mixing is ``core.mixing.mix_stacked`` -- on
the card the ``gossip_schedule`` kernel for a schedule or a
``ScheduleArrays``, the ``gossip_mix`` kernel for a dense W and the
complete graph.

Modes:

* ``dsgd`` -- ``n_nodes`` replicas; each step takes every node's gradient
  on its own batch (one autograd pass per node over views ``leaf[i]``,
  in a Python loop, so each node's activations are freed before the
  next), the local SGD (momentum) half-step on the stacked leaves, then
  the mix: a static ``BirkhoffSchedule`` (``schedule=None``: the complete
  graph), or with ``online_w=True`` the step's trailing ``mix_w`` operand
  -- a dense ``(n, n)`` W or a ``ScheduleArrays`` (the reference's
  ``"allgather"`` transport; on one card simply ``mix_stacked``).
* ``fsdp`` -- one global model on a ``(batch, ...)`` batch, no node axis
  (the reference's C-PSGD baseline, W = 11^T / n).

Training runs ``impl="plain"`` under autograd: no kernel of the reference
has a backward pass, so ``impl="kernel"`` is refused rather than run
through the forward-only flash kernel.

``TrainSetup.multi_step_fn(rollout)`` is the counterpart of the
reference's ``lax.scan`` rollout: ``"scan"`` runs the steps as captured
bodies of at most ``rollout.MAX_GRAPH_STEPS`` steps (``graphs.GraphRunner``:
an eager warm-up on a side stream, a CUDA-graph capture at a body's
second run, replays after), with the parameters, the momentum, the step
counter and the gradient buffers as static carries and each step's batch
a static input; ``"loop"`` runs the same bodies eagerly. Both run the same
operations on the same tensors (bitwise equal on the card). A swapped
mixing operand reaches the bodies by ``copy_`` into their static
operand, so it recaptures nothing.

``gossip_every = k > 1`` mixes on the steps whose counter is a multiple
of k. The reference branches on its device counter (``lax.cond``); a
CUDA graph freezes host branches, so here each body's on/off pattern is
static: bodies are keyed by the counter's phase at their first step,
read on the host once per multi-step call (outside any capture). Off
steps launch no mixing kernel.

``TrainSetup.run_segments`` is the reference's segmented online rollout:
a hook that swaps W or a ``ScheduleArrays`` at boundaries, checkpoints
(``train/checkpoints.py``, bfloat16 leaves by their bits) with a bitwise
resume, a tracer and a retrace guard.

Not ported here (``NotImplementedError``, ROADMAP queue 1 item 13c, the
multi-rank transports): ``mode="dsgd_pod"``, ``sharded_transport="pool"``,
``pool=``, a ``PoolSwap`` from the hook, and ``compression=``,
``staleness=``, ``probes=``, ``delays=`` and ``quarantine=``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.core.mixing import (
    BirkhoffSchedule,
    PoolSwap,
    ScheduleArrays,
    mix_dense,
    mix_schedule_arrays,
    mix_stacked,
)
from repro_torch.device import resolve_device
from repro_torch.graphs import Body, GraphRunner
from repro_torch.models import registry, transformer, whisper
from repro_torch.models.common import IMPLS, ModelConfig
from repro_torch.obs.trace import Tracer

from .checkpoints import latest_step, restore_checkpoint, save_checkpoint
from .metrics import CommMeter, mix_bytes_per_step
from .rollout import chunks

__all__ = ["TrainSetup", "make_train_setup", "gossip_fn", "NOT_PORTED_LM"]

PyTree = Any
Params = dict[str, torch.Tensor]

NOT_PORTED_LM = "not ported yet (ROADMAP queue 1 item 13c: the multi-rank transports)"

# instrumented paths take an always-on tracer; callers opt in with a real one
_NULL_TRACER = Tracer(enabled=False)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {NOT_PORTED_LM}")


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
    """Whether ``opt`` is the ``{"step", "m"}`` dict of the reference's
    convention (a bare momentum tree is keyed by parameter names)."""
    return isinstance(opt, dict) and bool(opt) and set(opt) <= {"step", "m"}


def _leading(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


class _Loss(nn.Module):
    """The model's loss as a module, for ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module, cfg: ModelConfig, impl: str):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.impl = impl

    def forward(self, batch: dict) -> torch.Tensor:
        return registry.loss_fn(self.model, self.cfg, batch, impl=self.impl)[0]


def gossip_fn(schedule: BirkhoffSchedule | None, n_nodes: int, *,
              use_kernel: bool = False) -> Callable[[Params], Params]:
    """The static mixing of stacked parameters: the Birkhoff schedule's
    gathers (``gossip_schedule`` on the card), or with ``schedule=None``
    the complete graph, W = 11^T / n (``gossip_mix``). ``use_kernel``
    gives the kernels' numerics on the CPU (float32 sums); without it the
    CPU sums in the leaf dtype."""
    if schedule is not None:
        if schedule.n_nodes != n_nodes:
            raise ValueError(f"schedule has {schedule.n_nodes} nodes, the setup {n_nodes}")
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


def _static_operand(mix, device: torch.device):
    """A mixing operand as the tensors the step reads: a ScheduleArrays
    (float32 gammas, int32 perms) or a float32 (n, n) W."""
    if isinstance(mix, PoolSwap):
        raise _not_ported("a PoolSwap (the staged-pool transport)")
    if isinstance(mix, ScheduleArrays):
        return ScheduleArrays(
            gammas=torch.as_tensor(mix.gammas, dtype=torch.float32, device=device),
            perms=torch.as_tensor(mix.perms, dtype=torch.int32, device=device))
    if isinstance(mix, torch.Tensor):
        w = mix.detach().to(device=device, dtype=torch.float32)
    else:
        w = torch.as_tensor(np.asarray(mix, dtype=np.float32), device=device)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        if w.ndim == 1:
            raise _not_ported("pool-coordinate gammas (the staged-pool transport)")
        raise ValueError(f"mix_w must be an (n, n) W or a ScheduleArrays, got {tuple(w.shape)}")
    return w


def _operand_key(mix) -> tuple:
    if mix is None:
        return ("static",)
    if isinstance(mix, ScheduleArrays):
        return ("arrays", mix.l_max)
    return ("dense",)


class _Step:
    """The step's math, shared by ``train_step`` and the rollouts: every
    function here reads and writes the tensors it is given in place."""

    def __init__(self, cfg: ModelConfig, *, mode: str, n_nodes: int, lr: float,
                 momentum: float, impl: str, grad_accum: int, gossip_every: int,
                 online_w: bool, schedule: BirkhoffSchedule | None, device: torch.device):
        self.mode, self.n_nodes = mode, n_nodes
        self.lr, self.momentum = lr, momentum
        self.grad_accum, self.gossip_every = grad_accum, gossip_every
        self.device = device
        meta = whisper.Whisper(cfg, "meta") if cfg.arch_type == "audio" else \
            transformer.LM(cfg, "meta")
        self.loss_module = _Loss(meta, cfg, impl)
        self.static_mix = gossip_fn(schedule, n_nodes) \
            if mode == "dsgd" and not online_w else None

    # -- gradients -----------------------------------------------------------

    def _loss_grads(self, leaves: Params, batch: dict) -> tuple[torch.Tensor, Params]:
        """One model's loss and gradients on ``batch`` (leading axis the
        batch); with ``grad_accum`` the mean over its microbatches,
        accumulated in float32 and cast to the leaves' dtype."""
        named = {"model." + k: v.detach().requires_grad_() for k, v in leaves.items()}
        keys = list(named)

        def one(b: dict):
            loss = torch.func.functional_call(self.loss_module, named, (b,))
            return loss, torch.autograd.grad(loss, [named[k] for k in keys])

        if self.grad_accum == 1:
            loss, grads = one(batch)
            return loss.detach(), dict(zip(leaves, grads))
        micro = _leading(batch) // self.grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = [torch.zeros(named[k].shape, dtype=torch.float32, device=self.device)
               for k in keys]
        for a in range(self.grad_accum):
            loss, grads = one({k: v[a * micro:(a + 1) * micro] for k, v in batch.items()})
            loss_sum = loss_sum + loss.detach()
            for s, g in zip(acc, grads):
                s.add_(g)
        grads = {name: (s / self.grad_accum).to(leaves[name].dtype)
                 for name, s in zip(leaves, acc)}
        return loss_sum / self.grad_accum, grads

    def grads_(self, params: Params, batch: dict, out: Params) -> torch.Tensor:
        """Every node's gradient into ``out`` (in place); the per-node losses
        (n,) in float32 -- fsdp: the global model's loss, a 0-d tensor."""
        if self.mode == "fsdp":
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

    def mix(self, half: Params, operand) -> Params:
        if operand is None:
            return self.static_mix(half)
        if isinstance(operand, ScheduleArrays):
            return mix_schedule_arrays(half, operand)
        return mix_dense(half, operand)

    def step_(self, params: Params, opt, batch: dict, operand, gossip: bool,
              grads: Params) -> torch.Tensor:
        """One step on ``params`` / ``opt`` in place (``grads``: scratch
        buffers); returns the step's loss (the mean over nodes), float32."""
        losses = self.grads_(params, batch, grads)
        m = opt.get("m") if _is_carry_dict(opt) else opt
        half, new_m = _sgd_update(params, grads, m, self.lr, self.momentum)
        if self.mode == "dsgd" and gossip:
            half = self.mix(half, operand)
        _copy_into(params, half)
        if self.momentum > 0.0:
            _copy_into(m, new_m)
        if _is_carry_dict(opt) and "step" in opt:
            opt["step"].add_(1)
        return losses.mean()

    def gossip_at(self, step: int) -> bool:
        return self.mode == "dsgd" and step % self.gossip_every == 0

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
    losses: torch.Tensor | None = None


class _Rollout:
    """``multi_step(params, opt_state, batches[, mix_w]) -> (params,
    opt_state, losses)`` over static carries, as captured (``"scan"``) or
    eager (``"loop"``) bodies of at most ``MAX_GRAPH_STEPS`` steps.

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
        value = _static_operand(mix, self.setup._core.device)
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
        losses = torch.empty((k,), dtype=torch.float32, device=core.device)
        pattern = [core.gossip_at(phase + j) for j in range(k)]

        def fn() -> None:
            for j in range(k):
                losses[j] = core.step_(self.params, self.opt,
                                       {name: v[j] for name, v in inputs.items()},
                                       operand, pattern[j], self.grads)

        body = self._bodies[key] = _RolloutBody(fn, batch=inputs, losses=losses)
        return body

    def _run(self, body: _RolloutBody) -> None:
        if self.captured:
            self._graphs.run(body, "train segment body")
            return
        if id(body) not in self._seen:
            self._seen.add(id(body))
            self._graphs.count()
        body.fn()

    def __call__(self, params: Params, opt_state, batches: dict, *mix_w):
        self.setup._check_online_args(mix_w)
        core = self.setup._core
        operand = self._operand(mix_w[0]) if mix_w else None
        self._bind(params, opt_state)
        phase = core.phase(self.opt)
        batches = {name: torch.as_tensor(v, device=core.device) for name, v in batches.items()}
        steps = _leading(batches)
        out, t = [], 0
        for k in chunks(steps):
            body = self._body(k, batches, operand, (phase + t) % core.gossip_every)
            for name, v in body.batch.items():
                v.copy_(batches[name][t:t + k])
            self._run(body)
            out.append(body.losses.clone())
            t += k
        losses = torch.cat(out) if out else torch.zeros((0,), device=core.device)
        return _clone(self.params), _clone(self.opt), losses


def _checkpoint_leaf(t: torch.Tensor) -> torch.Tensor:
    """A checkpointable view: bfloat16 by its bits (numpy has no bfloat16)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _checkpoint_tree(params: Params, opt, mix) -> dict:
    def view(tree):
        if isinstance(tree, dict):
            return {k: view(v) for k, v in tree.items() if v is not None}
        return _checkpoint_leaf(tree)

    tree = {"params": view(params)}
    if opt is not None:
        tree["opt"] = view(opt)
    if isinstance(mix, ScheduleArrays):
        tree["mix"] = {"gammas": mix.gammas, "perms": mix.perms}
    else:
        tree["mix"] = mix
    return tree


def _restore_into(like, values, device: torch.device):
    """Numpy ``values`` (in ``like``'s structure) as tensors of ``like``'s
    dtypes on ``device``."""
    if isinstance(like, dict):
        return {k: _restore_into(like[k], values[k], device) if like[k] is not None else None
                for k in like}
    t = torch.from_numpy(np.array(values)).to(device)
    return t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t.to(like.dtype)


@dataclasses.dataclass
class TrainSetup:
    """The LM trainer of one ``(cfg, mode)``: the step, its rollouts and
    the segmented online rollout.

    ``train_step(params, opt_state, batch[, mix_w]) -> (params, opt_state,
    loss)`` is one eager step on copies (the inputs are left as they
    were); ``params`` is a dict of tensors named as the model's
    parameters, with a leading node axis in ``dsgd`` mode (``batch``
    leaves ``(n, per_node, ...)``) and none in ``fsdp`` (``(batch, ...)``);
    ``loss`` is the mean over nodes, float32. ``grad_fn(params, batch) ->
    (losses, grads)`` gives every node's loss and gradient without a
    step. ``init_params(seed)`` draws one model from ``seed``
    (``registry.init_model``) and, in ``dsgd`` mode, copies it to every
    node (Algorithm 1: one init).
    """

    train_step: Callable
    init_params: Callable
    grad_fn: Callable
    mode: str
    n_nodes: int
    online_w: bool = False
    sharded_transport: str | None = None
    comm_bytes_per_step: int | None = None
    _core: _Step | None = dataclasses.field(default=None, repr=False, compare=False)
    _init_opt_state: Callable | None = dataclasses.field(default=None, repr=False,
                                                         compare=False)

    def init_opt_state(self, params: Params):
        """The opt state the step carries, in the reference's convention:
        None when nothing is carried, the bare momentum tree for momentum
        alone, else a dict with ``"step"`` (a 0-d int32 counter, for
        ``gossip_every > 1``) and ``"m"`` (the momentum)."""
        if self._init_opt_state is None:
            raise ValueError("init_opt_state needs a setup built by make_train_setup")
        return self._init_opt_state(params)

    def multi_step_fn(self, rollout: str = "scan", *, retrace_guard=None) -> _Rollout:
        """``multi_step(params, opt_state, batches[, mix_w]) -> (params,
        opt_state, losses)``: every ``batches`` leaf carries a leading
        time axis ``(k, ...)``; ``losses`` is ``(k,)``. ``"scan"``
        captures its bodies as CUDA graphs (on the CPU it runs them
        eagerly, counting captures as the card would), ``"loop"`` runs
        the same bodies eagerly. The function keeps its bodies and static
        carries across calls; ``n_traces`` counts its captures."""
        if rollout not in ("scan", "loop"):
            raise ValueError(f"unknown rollout {rollout!r}")
        return _Rollout(self, rollout == "scan", retrace_guard)

    def _check_online_args(self, mix_w: tuple) -> None:
        if self.online_w and len(mix_w) != 1:
            raise TypeError("online_w setup: call multi_step(params, opt_state, batches, mix_w)")
        if not self.online_w and mix_w:
            raise TypeError("this setup was built without online_w; no mix_w argument expected")

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
        every segment but the last may return None, a ``ScheduleArrays``
        or an ``(n, n)`` W, copied into the bodies' static operand (no
        capture added). With ``checkpoint_dir``, ``{params, opt, mix}``
        is saved every ``checkpoint_every``-th boundary after the hook
        (and at the end and at an early stop); ``resume`` restores the
        newest and continues, bitwise the uninterrupted run;
        ``stop_after_segments`` ends the run early (``stopped_at``).
        ``tracer`` records ``segment.rollout`` / ``segment.checkpoint``
        spans, ``retrace_guard`` the captures under
        ``"run_segments.multi_step"``.

        Returns ``{"params", "opt_state", "losses", "n_traces", "swaps",
        "recompiles", "segment_s", "comm", "setup", "mix", "resumed_from",
        "stopped_at"}``; ``recompiles`` is always 0 (no pool restage).
        """
        if delays is not None:
            raise _not_ported("delays (bounded-delay gossip)")
        if quarantine is not None:
            raise _not_ported("quarantine accounting")
        if not self.online_w:
            raise ValueError("run_segments needs an online_w=True setup")
        if segment_len < 1:
            raise ValueError(f"segment_len must be >= 1, got {segment_len}")
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        tracer = _NULL_TRACER if tracer is None else tracer
        device = self._core.device
        steps = _leading(batches)
        msj = self.multi_step_fn(rollout, retrace_guard=retrace_guard)
        mix = _static_operand(mix, device)
        meter = CommMeter(per_step_bytes=self.comm_bytes_per_step or 0)
        losses, swaps, segment_s = [], [], []
        t0, resumed_from, stopped_at = 0, None, None
        if checkpoint_dir is not None and resume:
            last = latest_step(checkpoint_dir)
            if last is not None:
                like = _checkpoint_tree(params, opt_state, mix)
                tree, _ = restore_checkpoint(checkpoint_dir, last, like)
                params = _restore_into(params, tree["params"], device)
                if opt_state is not None:
                    opt_state = _restore_into(opt_state, tree["opt"], device)
                mix = (ScheduleArrays(*(torch.from_numpy(np.array(tree["mix"][k])).to(device)
                                        for k in ("gammas", "perms")))
                       if isinstance(mix, ScheduleArrays)
                       else torch.from_numpy(np.array(tree["mix"])).to(device))
                t0 = resumed_from = int(last)

        def save(t: int) -> None:
            with tracer.span("segment.checkpoint", t=int(t)):
                save_checkpoint(checkpoint_dir, t, _checkpoint_tree(params, opt_state, mix),
                                metadata={"t": int(t)})

        seg_idx = 0
        while t0 < steps:
            k = min(segment_len, steps - t0)
            seg = {name: v[t0:t0 + k] for name, v in batches.items()}
            tic = time.perf_counter()
            with tracer.span("segment.rollout", t0=t0, k=k):
                params, opt_state, loss = msj(params, opt_state, seg, mix)
                loss = loss.cpu().numpy()
            segment_s.append(time.perf_counter() - tic)
            meter.tick(k)
            losses.append(loss)
            t0 += k
            seg_idx += 1
            if on_segment is not None and t0 < steps:  # no hook after the final segment
                update = on_segment(t0 - 1)
                if update is not None:
                    swaps.append(t0 - 1)
                    mix = _static_operand(update, device)
            if checkpoint_dir is not None and (seg_idx % checkpoint_every == 0 or t0 >= steps):
                save(t0)
            if stop_after_segments is not None and seg_idx >= stop_after_segments and t0 < steps:
                if checkpoint_dir is not None and seg_idx % checkpoint_every != 0:
                    save(t0)  # the crash drill must leave a resumable state
                stopped_at = t0
                break
        return {
            "params": params,
            "opt_state": opt_state,
            "losses": np.concatenate(losses) if losses else np.zeros((0,)),
            "n_traces": msj.n_traces,
            "swaps": swaps,
            "recompiles": 0,
            "segment_s": segment_s,
            "comm": meter.summary(),
            "setup": self,
            "mix": mix,
            "resumed_from": resumed_from,
            "stopped_at": stopped_at,
        }


def make_train_setup(
    cfg: ModelConfig,
    *,
    n_nodes: int = 1,
    mode: str = "dsgd",
    schedule: BirkhoffSchedule | None = None,
    lr: float = 1e-3,
    momentum: float = 0.0,
    impl: str = "plain",
    grad_accum: int = 1,
    gossip_every: int = 1,
    online_w: bool = False,
    sharded_transport: str = "auto",
    pool=None,
    compression=None,
    staleness=None,
    probes=None,
    device: torch.device | str | None = None,
) -> TrainSetup:
    """The train step for ``(cfg, mode)`` with ``n_nodes`` stacked nodes on
    ``device`` (None = CUDA): the reference's ``make_train_setup`` with
    ``mesh`` replaced by ``n_nodes`` (ignored in ``fsdp`` mode, which has
    one global model) and ``device``.

    ``schedule=None`` in dsgd mode means complete-graph mixing;
    ``online_w=True`` makes the mixing operand a trailing argument of the
    step (a dense (n, n) W or a ``ScheduleArrays``; ``sharded_transport``
    ``"auto"`` / ``"allgather"`` both resolve to ``"allgather"``).
    ``grad_accum > 1`` splits each node's batch into microbatches and
    takes the mean of their gradients (float32 accumulation);
    ``gossip_every = k > 1`` mixes only on steps whose counter (carried in
    the opt state, see ``init_opt_state``) is a multiple of k. The mix
    runs in the gossip kernels on the card, in the reference's numerics
    (sums in the leaf dtype) on the CPU.
    """
    if mode == "dsgd_pod":
        raise _not_ported("mode='dsgd_pod'")
    if mode not in ("dsgd", "fsdp"):
        raise ValueError(f"unknown mode {mode}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        raise ValueError(
            "impl='kernel' cannot train: the flash-attention and RG-LRU scan kernels are "
            "forward only (the reference's Pallas kernels have no backward); use impl='plain'")
    for name, value in (("compression", compression), ("staleness", staleness),
                        ("probes", probes), ("pool", pool)):
        if value is not None:
            raise _not_ported(f"{name}=")
    if sharded_transport == "pool":
        raise _not_ported("sharded_transport='pool'")
    if sharded_transport not in ("auto", "allgather"):
        raise ValueError(f"unknown sharded_transport {sharded_transport!r}")
    if online_w and mode == "fsdp":
        raise ValueError("online_w needs a node axis (dsgd); fsdp has no W")
    if online_w and schedule is not None:
        raise ValueError("online_w and a static schedule are mutually exclusive -- pass the "
                         "initial W as the mix_w argument of the step instead")
    if grad_accum < 1 or gossip_every < 1:
        raise ValueError(f"grad_accum and gossip_every must be >= 1, got {grad_accum}, "
                         f"{gossip_every}")
    device = resolve_device(device)
    n = n_nodes if mode == "dsgd" else 1
    if schedule is not None and schedule.n_nodes != n:
        raise ValueError(f"schedule has {schedule.n_nodes} nodes, the setup provides {n}")
    if schedule is not None:
        schedule.operands(device)  # made and checked once, before any capture
    core = _Step(cfg, mode=mode, n_nodes=n, lr=lr, momentum=momentum, impl=impl,
                 grad_accum=grad_accum, gossip_every=gossip_every, online_w=online_w,
                 schedule=schedule, device=device)

    def init_params(seed: int = 0) -> Params:
        model = registry.init_model(cfg, seed=seed, device=device)
        single = {name: p.detach() for name, p in model.named_parameters()}
        if mode == "fsdp":
            return single
        return {name: p[None].expand((n,) + tuple(p.shape)).clone() for name, p in single.items()}

    p_total = sum(int(np.prod(p.shape)) for p in core.loss_module.model.parameters())
    resolved = comm = None
    if mode == "dsgd":
        if online_w:
            resolved = "allgather"
            comm = mix_bytes_per_step("allgather", n_nodes=n, p_total=p_total)
        elif schedule is not None:
            comm = mix_bytes_per_step("ppermute", n_nodes=n, p_total=p_total,
                                      n_comm_atoms=schedule.n_communication_atoms)
        else:
            comm = mix_bytes_per_step("allreduce", n_nodes=n, p_total=p_total)

    def grad_fn(params: Params, batch: dict):
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        losses = core.grads_(params, batch, grads)
        return losses, grads

    def train_step(params: Params, opt_state, batch: dict, *mix_w):
        setup._check_online_args(mix_w)
        params, opt_state = _clone(params), _clone(opt_state)
        operand = _static_operand(mix_w[0], device) if mix_w else None
        gossip = core.gossip_at(core.phase(opt_state))
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        loss = core.step_(params, opt_state, batch, operand, gossip, grads)
        return params, opt_state, loss

    def init_opt_state(params: Params):
        out: dict = {}
        if gossip_every > 1:
            out["step"] = torch.zeros((), dtype=torch.int32, device=device)
        if momentum > 0.0:
            out["m"] = {k: torch.zeros_like(v) for k, v in params.items()}
        if not out:
            return None
        if set(out) == {"m"}:
            return out["m"]
        return out

    setup = TrainSetup(
        train_step=train_step, init_params=init_params, grad_fn=grad_fn, mode=mode,
        n_nodes=n, online_w=online_w, sharded_transport=resolved,
        comm_bytes_per_step=comm, _core=core, _init_opt_state=init_opt_state,
    )
    return setup
