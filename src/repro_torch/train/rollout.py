"""Captured rollouts: the port's counterpart of the reference's
``jax.jit(lax.scan)`` rollout closures.

The reference compiles the steps between two segment boundaries into one
``lax.scan`` and runs every later segment of the same shape on that one
compiled program; a schedule hot swap reaches it as data. Here the same
rollout is a CUDA graph:

* a *segment body* is a Python function of no arguments that runs ``k``
  D-SGD steps. It reads only static input tensors (the parameters, this
  chunk's observations or minibatch indices, the schedule's ``gammas`` /
  ``perms``) and writes its results into static output tensors (the
  parameters again, the per-step traces), so running it again continues
  where it stopped. A driver builds one body per distinct ``(k, shape)``
  (``shape``: the schedule's ``l_max``, or None for a static W or
  ``BirkhoffSchedule``) and fills its inputs before each run.
* :meth:`SegmentRunner.run_segment` runs a segment as bodies of at most
  ``MAX_GRAPH_STEPS`` steps. With ``captured=True`` each body runs through
  ``repro_torch.graphs.GraphRunner``: its first run is the eager warm-up
  on a side stream, its second the capture into a CUDA graph (one
  capture, recorded under the runner's name in the ``RetraceGuard``)
  and a replay, later runs replays; a body that runs only once is never
  captured. On the CPU the body runs eagerly every time, with the same
  counting, so CPU tests hold the capture counts. With ``captured=False``
  (the ``"loop"`` rollout) every run is eager and the runner counts one
  body per distinct ``shape``, as the reference's jitted step traces
  once per shape.
* :meth:`SegmentRunner.swap` copies a new schedule into the static
  ``gammas`` / ``perms`` the bodies read (``copy_``, never a rebind), so
  a swap changes values and recaptures nothing; a schedule of another
  ``l_max`` gets buffers of its own, hence new bodies and, on their
  second run, one more capture -- as the reference retraces.
* The rest of the state a run carries from body to body is static too,
  registered with :meth:`SegmentRunner.carry` under a name: the
  parameters, the EF memory of compressed gossip, the bounded-delay
  ring and its head (an int64 tensor on the device, advanced by the
  body, so a replay pushes into and reads the slots of the step it
  replays), the ``pi_hat`` the tau_bar probe reads. A new value reaches
  them by ``copy_`` (:meth:`SegmentRunner.refresh`, a checkpoint's
  :meth:`SegmentRunner.load_state_dict`), never by a rebind. Per-step
  streams -- observations, minibatch indices, the delays and the
  repaired ``(k, L)`` gammas / ``(k, L, n)`` perms of bounded-delay
  gossip, the wire-corruption planes -- are a body's static inputs,
  filled before each run; its per-step outputs (the trace, probe values,
  screen statistics) are static outputs, one tensor or a tuple of them.
  So a changed delay stream, a ``pi_hat`` refresh, a quarantine (a
  repaired schedule stream) or a restored checkpoint are all values:
  none adds a capture.

What a graph freezes at capture (kernel launch counts, the generators'
states) and the refusal to fall back to the eager body on the card are
``GraphRunner``'s (``repro_torch/graphs.py``). Captures use the default
``"global"`` capture mode: the online controller's overlap worker, the
only other thread that may run during a capture, makes no CUDA call
(``online/refresh.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable

import torch

from repro_torch.core.mixing import ScheduleArrays
from repro_torch.graphs import Body, GraphRunner, release

__all__ = ["MAX_GRAPH_STEPS", "SegmentRunner", "chunks"]

# A segment longer than this runs as several bodies of at most this many
# steps (and one shorter remainder), so a long static run replays one
# bounded graph instead of capturing every step into a single graph.
MAX_GRAPH_STEPS = 64


def chunks(length: int) -> list[int]:
    """Body lengths a segment of ``length`` steps runs as, in order."""
    full, rest = divmod(length, MAX_GRAPH_STEPS)
    return [MAX_GRAPH_STEPS] * full + ([rest] if rest else [])


Outputs = torch.Tensor | tuple[torch.Tensor, ...]


@dataclasses.dataclass
class _Body(Body):
    inputs: object = None
    outputs: Outputs | None = None


class SegmentRunner:
    """Runs segment bodies eagerly (``captured=False``) or as CUDA graphs.

    Args:
      name: the ``RetraceGuard`` name its captures are recorded under
        (the reference's ``"mean_estimation.roll"`` /
        ``"classification.roll"``).
      device: the run's device; graphs are captured only on CUDA.
      captured: the ``"scan"`` rollout (capture and replay) or the
        ``"loop"`` rollout (eager every time).
      retrace_guard: an ``obs.RetraceGuard`` to record captures in.
      generators: the device generators the bodies draw from.
      tracer: an ``obs.trace.Tracer`` for the graph runner's
        ``graph.warmup`` / ``graph.capture`` spans.
    """

    def __init__(
        self,
        name: str,
        device: torch.device,
        *,
        captured: bool,
        retrace_guard=None,
        generators: tuple[torch.Generator, ...] = (),
        tracer=None,
    ):
        self.name = name
        self.device = device
        self.captured = captured
        self._graphs = GraphRunner(
            name, device, retrace_guard=retrace_guard, generators=generators,
            fallback=" (run with rollout='loop')", tracer=tracer,
        )
        self._bodies: dict[Hashable, _Body] = {}
        self._shapes: set = set()
        self._schedules: dict[int, ScheduleArrays] = {}
        self._carry: dict[str, torch.Tensor] = {}

    @property
    def n_traces(self) -> int:
        """Captures (``"scan"``) or distinct schedule shapes (``"loop"``)."""
        return self._graphs.n_traces

    # -- schedule buffers --------------------------------------------------

    def swap(self, new: ScheduleArrays) -> ScheduleArrays:
        """Copy ``new`` into the static schedule buffers of its ``l_max``
        (made on first sight) and return those buffers."""
        static = self._schedules.get(new.l_max)
        if static is None:
            static = ScheduleArrays(
                gammas=torch.empty_like(new.gammas, dtype=torch.float32, device=self.device),
                perms=torch.empty_like(new.perms, dtype=torch.int32, device=self.device),
            )
            self._schedules[new.l_max] = static
        if new.perms.shape != static.perms.shape:
            raise ValueError(
                f"schedule swap: perms {tuple(new.perms.shape)} do not match the "
                f"run's {tuple(static.perms.shape)}"
            )
        static.gammas.copy_(new.gammas)
        static.perms.copy_(new.perms)
        return static

    # -- static carry --------------------------------------------------------

    def carry(self, name: str, init: torch.Tensor) -> torch.Tensor:
        """The static tensor registered as ``name``: made once, on the run's
        device, from ``init`` (copied); a later call returns the same
        tensor. Bodies read and write it in place."""
        if name not in self._carry:
            self._carry[name] = init.detach().to(self.device).clone()
        return self._carry[name]

    def refresh(self, name: str, value) -> None:
        """Copy a new value into the static tensor ``name`` (``copy_``: the
        captured bodies see it at their next replay)."""
        self._carry[name].copy_(torch.as_tensor(value).to(self._carry[name].dtype))

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The registered static tensors, by name (the live tensors)."""
        return dict(self._carry)

    def load_state_dict(self, values: dict) -> None:
        """Copy each ``name -> value`` into its registered static tensor."""
        for name, value in values.items():
            if tuple(self._carry[name].shape) != tuple(value.shape):
                raise ValueError(
                    f"{self.name}: {name} is {tuple(self._carry[name].shape)}, the "
                    f"restored value {tuple(value.shape)}"
                )
            self.refresh(name, value)

    # -- bodies ------------------------------------------------------------

    def run_segment(
        self,
        t0: int,
        length: int,
        schedule,
        make_body: Callable[[int, object], tuple[Callable[[], None], object, Outputs]],
        fill: Callable[[object, int, int], None],
    ) -> Outputs:
        """Run steps ``t0 .. t0 + length - 1`` as bodies of at most
        ``MAX_GRAPH_STEPS`` steps.

        ``schedule`` is what the bodies mix with: the static buffers
        :meth:`swap` returned, or a static W's or ``BirkhoffSchedule``'s
        stand-in (its shape is None). ``make_body(k, schedule)`` returns
        ``(fn, inputs, outputs)`` for a body of ``k`` steps; it is called
        once per ``(k, l_max)``. ``fill(inputs, t, k)`` writes the inputs
        of steps ``t .. t + k - 1`` before each run. Returns the bodies'
        per-step outputs, in order, on the device: one tensor, or a tuple
        of tensors where the bodies' outputs are a tuple.
        """
        shape = schedule.l_max if isinstance(schedule, ScheduleArrays) else None
        outs, t = [], t0
        for k in chunks(length):
            key = (k, shape)
            if key not in self._bodies:
                fn, inputs, outputs = make_body(k, schedule)
                self._bodies[key] = _Body(fn, inputs=inputs, outputs=outputs)
            body = self._bodies[key]
            fill(body.inputs, t, k)
            self._run(key, shape)
            # the next run of the body overwrites them
            if isinstance(body.outputs, torch.Tensor):
                outs.append(body.outputs.clone())
            else:
                outs.append(tuple(o.clone() for o in body.outputs))
            t += k
        if outs and not isinstance(outs[0], torch.Tensor):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    def release(self) -> None:
        """Drop the bodies and their graphs (``graphs.release``) at the end
        of a run. The carries stay; a later segment builds its bodies
        anew."""
        release(self._bodies)

    def _run(self, key: Hashable, shape: Hashable) -> None:
        """Run the body of ``key`` once (eagerly, or through the graph runner;
        see the module docstring)."""
        body = self._bodies[key]
        if self.captured:
            self._graphs.run(body, f"segment body {key!r}")
            return
        if shape not in self._shapes:
            self._shapes.add(shape)
            self._graphs.count()
        body.fn()
