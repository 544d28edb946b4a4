"""What every cell shares: finding its files by name, the harness's spans,
the card's description, reading the profiler's trace, and the result line.

Nothing here imports the port: the drivers do (``drivers/``), and the
plain references (``reference/``) import neither the port nor JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# top-level module names no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# the harness's own spans: what the host was doing, in a gap's name
HARNESS_SPANS = ("bench.call", "bench.segment", "bench.traced")


# ---------------------------------------------------------------------------
# Files found by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def entry(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """The workload's entry, its configuration file and its traffic file."""
    w = entry(bench["workloads"], workload, "workload")
    c = entry(bench["configs"], w["config"], "configuration")
    config = load_json(root / c["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{w['name']}.json")
    return w, config, traffic


def module_path(kind: str, name: str, root: Path = ROOT) -> Path:
    """``perfbench/<kind>/<name>.py``; for a name ``<family>.<part>`` with no
    file of its own, the family's ``<family>.py`` (one reader serves
    ``idle_share.sim`` and ``idle_share.train``)."""
    folder = root / "perfbench" / kind
    path = folder / f"{name}.py"
    if not path.is_file() and "." in name:
        path = folder / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {folder / name}.py")
    return path


def load_module(kind: str, name: str, root: Path = ROOT):
    """``module_path(kind, name)`` as a module (names may hold dots)."""
    path = module_path(kind, name, root)
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def peaks(root: Path = ROOT) -> dict:
    return load_json(root / "perfbench" / "peaks.json")


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this workload reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def kernel_names(family: str, root: Path = ROOT) -> tuple[str, ...]:
    """The device kernels of one family, by name: every line of every
    ``perfbench/kernel_names/<family>/*.txt`` (a kernel the port adds or
    renames is a line in a file of its own)."""
    names = []
    for path in sorted((root / "perfbench" / "kernel_names" / family).glob("*.txt")):
        names += [line.strip() for line in path.read_text().splitlines() if line.strip()]
    return tuple(names)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# What a driver is given and gives back
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """One run of one cell, as a driver sees it."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    config: dict
    traffic: dict
    peaks: dict
    spans: "Spans"
    say: object = print  # a line before the result


@dataclasses.dataclass
class Outcome:
    """What a driver measured: the end-to-end metrics, the per-layer
    readers' inputs, the numbers compared with their limits."""

    attempted: int
    failed: int
    end_to_end: dict
    layer: dict
    checks: list
    memory_peak_bytes: int
    window_start: float  # time.perf_counter() at the window's start
    trace: "Trace | None" = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(value <= limit for _, value, limit in self.checks)


def gap_checks(numbers: dict, limits: dict) -> list[tuple[str, float, float]]:
    """(name, number, limit) for every limit of the cell; a number that is
    missing or not finite reads as infinite."""
    out = []
    for name, limit in limits.items():
        value = float(numbers.get(name, float("inf")))
        out.append((name, value if value == value else float("inf"), float(limit)))
    return out


# ---------------------------------------------------------------------------
# Spans recorded by the harness around its calls into the port
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    """Host-clock spans of the harness; while a profiler runs, each span is
    also a ``record_function`` range, so the trace names what the host
    was doing."""

    def __init__(self) -> None:
        self.records: list[Span] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        if self.profiling:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.records.append(Span(name, t0, time.perf_counter(), attrs))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unknown ({exc.__class__.__name__})"
    return " | ".join(line.strip() for line in out.splitlines())


def require_cards(count: int) -> None:
    """Exit without a result unless ``count`` CUDA devices are here: a
    measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: needs {count} CUDA device(s), found {have}", file=sys.stderr)
        raise SystemExit(2)


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------

def profiler_activities(device) -> list:
    """What ``torch.profiler`` records: host events, and the card's."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@dataclasses.dataclass
class Trace:
    """Device operations and host events of one traced window (ns on the
    profiler's clock)."""

    device: list[tuple[str, int, int]]
    host: list[tuple[str, int, int]]
    window: tuple[int, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def clipped(self) -> list[tuple[str, int, int]]:
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.device if b > lo and a < hi]

    def busy_s(self) -> float:
        """Seconds in the window in which a device operation ran (their union)."""
        spans = sorted((a, b) for _, a, b in self.clipped())
        busy, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e9

    def op_s(self, holds: tuple[str, ...] | None = None) -> float:
        """Summed device seconds of the operations whose name holds one of
        ``holds`` (all of them for None)."""
        return sum(b - a for n, a, b in self.clipped()
                   if holds is None or any(h in n for h in holds)) / 1e9

    def top_ops(self, k: int = 10) -> list[list]:
        by_name: dict[str, int] = {}
        for n, a, b in self.clipped():
            by_name[n] = by_name.get(n, 0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], ns / 1e9] for n, ns in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The longest stretches with no device operation, each named by the
        harness span and the innermost host event open at its middle."""
        lo, hi = self.window
        spans = sorted((a, b) for _, a, b in self.clipped())
        gaps, end = [], lo
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            out.append([self._host_at((a + b) // 2), (b - a) / 1e9])
        return out

    def _host_at(self, t: int) -> str:
        open_ = [(b - a, n) for n, a, b in self.host if a <= t <= b]
        harness = [n for _, n in sorted(open_) if n in HARNESS_SPANS]
        inner = [n for _, n in sorted(open_) if n not in HARNESS_SPANS]
        where = harness[0] if harness else "outside"
        return f"{where}/{inner[0][:100]}" if inner else f"{where}/host"


def read_trace(prof, window_span: str) -> Trace | None:
    """The device operations (kernels, copies, sets) and host events of
    ``prof`` (a finished ``torch.profiler.profile``), the window being the
    last host range named ``window_span``. Reads the raw events: building
    ``key_averages()`` costs ~0.1 ms an event on the host. None when the
    window was not recorded."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        ns = e.duration_ns()
        start = e.start_ns()
        name = e.name()
        if e.device_type() == cuda:
            if ns > 0 and not e.is_user_annotation():
                device.append((name, start, start + ns))
        else:
            host.append((name, start, start + ns))
            if name == window_span:
                window = (start, start + ns)
    if window is None:
        return None
    return Trace(device=device, host=host, window=window)


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

def emit(line: dict, checks: list[tuple[str, float, float]]) -> None:
    """The result: every number compared beside its limit as the last
    lines of standard error, and the JSON line (``checks`` last) as the
    last line of standard output."""
    for name, value, limit in checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    out = dict(line)
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
