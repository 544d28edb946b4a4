"""Capture and replay of static bodies as CUDA graphs: the core that the
captured rollout (``train/rollout.py``) and the captured decode step
(``serve/engine.py``) share.

A *body* is a Python function of no arguments that reads only static
input tensors and writes its results into static output tensors, so
running it again continues where it stopped. :meth:`GraphRunner.run`
runs a body as follows. Its first run is the warm-up: the body runs
eagerly, on a side stream on the card, and computes for real -- the
kernels are built and loaded, their one-time ``cudaFuncSetAttribute`` /
``cudaDeviceGetAttribute`` / occupancy calls run, cuBLAS and autograd
set up their state, all outside any capture. Its second run captures the
body into a ``torch.cuda.CUDAGraph`` (counted in ``n_traces``, and
recorded under the runner's name in a ``RetraceGuard``) and replays it;
later runs replay. A body that runs only once is never captured. On the
CPU the body runs eagerly every time, with the same counting, so CPU
tests hold the capture counts.

Two things a graph freezes at capture are handled here. Kernel launch
counts: a wrapper adds one to its count when the capture records its
launch, but the kernel runs only at replays, so the runner takes the
recorded launches back after the capture and adds them once per replay;
the bytes and calls ``core.mixing``'s collectives count
(``collective_bytes``, ``collective_calls``) are kept the same way.
Random draws: the generators a body draws from are registered with each
graph (``CUDAGraph.register_generator_state``), so replays draw what the
eager runs would have drawn and advance the generator alike.

Under a ``tracer`` (``obs.trace.Tracer``), a body's first run is the
span ``graph.warmup`` and its second the span ``graph.capture`` (on the
card the capture and its first replay; on the CPU the eager run counted
as one), with attributes ``runner`` (the runner's name) and ``what``,
so the ``graph.capture`` spans number ``n_traces``. While a profiler
records, each is also a named range in its trace, tracer or not.
Replays open no span.

A failed capture raises; the runner never falls back to the eager body
on the card. Captures use the default ``"global"`` capture mode, in
which a synchronising call or an allocation from ANY thread invalidates
an open capture. Device work started from another thread -- the online
controller's overlap worker solving with the device auction LMO --
therefore runs under :func:`device_work`, which holds the same lock a
capture holds: a capture waits for a solve in flight to end, and a solve
waits for an open capture to close.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Iterator

import torch

from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.gossip_mix import ops as _gossip_ops
from repro_torch.kernels.rglru_scan import ops as _scan_ops

__all__ = ["Body", "GraphRunner", "device_work", "release"]

_LAUNCH_COUNTS = (_gossip_ops.launch_counts, _flash_ops.launch_counts, _scan_ops.launch_counts)


def _counters() -> tuple[dict, ...]:
    """Every count a capture records: the kernels' launches, the
    collectives' bytes (``core.mixing`` imports this module's package
    through ``core``, so it is read here, not at import)."""
    from repro_torch.core.mixing import collective_bytes, collective_calls

    return _LAUNCH_COUNTS + (collective_bytes, collective_calls)
# held by every capture and by device work run outside the captured bodies
_capture_lock = threading.Lock()
_this_thread = threading.local()


@contextlib.contextmanager
def device_work() -> Iterator[None]:
    """Run device work that synchronises (a solve on a stream of its own)
    with no capture open: waits for a capture in another thread to close,
    and raises inside a capture, where the work could not run."""
    if getattr(_this_thread, "capturing", False):
        raise RuntimeError("device work cannot run inside a CUDA graph capture")
    with _capture_lock:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("device work cannot run inside a CUDA graph capture")
        yield


@dataclasses.dataclass
class Body:
    """A body and what its runs have left: the run count, its graph (on the
    card, from the second run), the kernel launches one replay makes and
    the capture's host seconds."""

    fn: Callable[[], None]
    runs: int = 0
    graph: "torch.cuda.CUDAGraph | None" = None
    launches: list[dict[str, int]] = dataclasses.field(default_factory=list)
    capture_s: float | None = None


def release(bodies: dict) -> None:
    """Drop ``bodies`` (a dict of :class:`Body`) and their graphs: each
    graph's memory pool goes with it, where the bodies' closures would
    keep them to the next garbage collection."""
    for body in bodies.values():
        body.graph = None
    bodies.clear()


class GraphRunner:
    """Runs bodies as CUDA graphs on the card (warm-up, capture, replay),
    eagerly on the CPU with the same counting.

    Args:
      name: the name its captures are recorded under.
      device: the device the bodies run on; graphs are captured only on CUDA.
      retrace_guard: an ``obs.RetraceGuard`` to record captures in.
      generators: the device generators the bodies draw from.
      fallback: what the error of a failed capture tells the caller to run
        instead.
      tracer: an ``obs.trace.Tracer`` to record the ``graph.warmup`` and
        ``graph.capture`` spans in.
    """

    def __init__(
        self,
        name: str,
        device: torch.device,
        *,
        retrace_guard=None,
        generators: tuple[torch.Generator, ...] = (),
        fallback: str = "",
        tracer=None,
    ):
        self.name = name
        self.device = device
        self.retrace_guard = retrace_guard
        self.generators = tuple(generators)
        self.fallback = fallback
        if tracer is None:  # read here, not at import, as in _counters
            from repro_torch.obs.trace import Tracer

            tracer = Tracer(enabled=False)
        self.tracer = tracer
        self.n_traces = 0
        # warm-ups and captures run on this side stream
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def count(self) -> None:
        """Count one capture (or, for the eager rollout, one trace)."""
        self.n_traces += 1
        if self.retrace_guard is not None:
            self.retrace_guard.record(self.name)

    def run(self, body: Body, what: object = "body") -> None:
        """Run ``body`` once: the eager warm-up at its first run, the capture
        and a replay at its second, a replay after that. ``what`` names the
        body in the error of a failed capture."""
        body.runs += 1
        if body.runs == 1:
            with self.tracer.span("graph.warmup", runner=self.name, what=what):
                self._warm_up(body)
            return
        if body.runs == 2:
            with self.tracer.span("graph.capture", runner=self.name, what=what):
                self.count()
                if self._stream is not None:
                    self._capture(body, what)
                self._replay(body)
            return
        self._replay(body)

    def _replay(self, body: Body) -> None:
        if body.graph is None:  # the CPU: eager, counted as on the card
            body.fn()
            return
        body.graph.replay()
        for counts, added in zip(_counters(), body.launches):
            for kernel, k in added.items():
                counts[kernel] += k

    def _warm_up(self, body: Body) -> None:
        if self._stream is None:
            body.fn()
            return
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            body.fn()
        current.wait_stream(self._stream)

    def _capture(self, body: Body, what: object) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = [dict(counts) for counts in _counters()]
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        try:
            with _capture_lock:
                _this_thread.capturing = True
                try:
                    with torch.cuda.graph(graph, stream=self._stream):
                        body.fn()
                finally:
                    _this_thread.capturing = False
        except Exception as exc:
            raise RuntimeError(
                f"{self.name}: capturing the {what} as a CUDA graph failed ({exc!r}); "
                f"the captured run does not fall back to the eager one{self.fallback}"
            ) from exc
        current.wait_stream(self._stream)
        # the capture recorded these launches; they run at each replay
        body.launches = []
        for counts, was in zip(_counters(), before):
            added = {k: counts[k] - was.get(k, 0) for k in counts if counts[k] != was.get(k, 0)}
            for kernel, k in added.items():
                counts[kernel] -= k
            body.launches.append(added)
        body.graph = graph
        body.capture_s = time.perf_counter() - t0
