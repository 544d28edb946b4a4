"""The simulator cells: back-to-back calls of the port's
``repro_torch.train.trainer.run_classification`` (n nodes of a linear
classifier, D-SGD on an STL-FW topology, the captured rollout, evaluation
every ``eval_every`` steps).

Set-up makes the data, the shard partition, the initial parameters and a
pool of minibatch indices from the seed, learns the topology with the
port's ``learn_topology`` and runs a call of two evaluation periods, so
that every kernel is built and every body shape a call runs has been
seen. The window then calls again and
again, each call on its own slice of the pool; a call started inside the
window is finished and counted with its time. A call pays its data
staging, its captures and its evaluations: a user of the simulator does.

Correctness: one call of the window, drawn from the seed, is run again
by the plain reference (``reference/linear_dsgd.py``) on the same inputs,
with a topology it learns itself from Pi (``reference/stlfw.py``): every
step's loss, and the consensus distance at each evaluation, against the
call's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.bench import (Context, Outcome, gap_checks, profiler_activities, read_trace,
                             sync)
from perfbench.counts import gossip, linear
from perfbench.gen import blobs
from perfbench.reference import linear_dsgd, precision, stlfw

_OFFSET_STRIDE = 7919  # a call's slice of the pool starts at c * stride mod the pool's spare


class Sim:
    """The cell's inputs, topology and the call into the port."""

    def __init__(self, ctx: Context):
        from repro_torch.core.mixing import autotune_transport, schedule_from_result
        from repro_torch.core.stl_fw import learn_topology

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx = ctx
        self.n, self.steps = tr["n_nodes"], tr["steps_per_call"]
        self.spare = tr["pool_spare_steps"]
        data = cfg["data"]
        with ctx.spans.span("bench.setup.data"):
            X, y = blobs.blobs(ctx.seed, data["n_samples"], cfg["num_classes"], cfg["dim"],
                               data["sep"], data["noise"], dev)
            n_train = data["n_samples"] - data["n_test"]
            self.X, self.y = X[:n_train], y[:n_train]
            self.X_test, self.y_test = X[n_train:], y[n_train:]
            self.nodes, self.Pi = blobs.shard_partition(self.y, self.n, tr["shards_per_node"],
                                                        ctx.seed, cfg["num_classes"])
            self.params0 = blobs.linear_params0(ctx.seed, cfg["dim"], cfg["num_classes"], dev)
            self.pool = blobs.batch_pool(ctx.seed, self.steps + self.spare,
                                         np.array([len(s) for s in self.nodes]),
                                         cfg["batch_size"], dev)
        with ctx.spans.span("bench.setup.stlfw"):
            tic = time.perf_counter()
            self.result = learn_topology(self.Pi, tr["budget"], lam=cfg["lam"])
            self.stlfw_s = time.perf_counter() - tic
        self.schedule = schedule_from_result(self.result)
        self.P = linear.params_per_node(cfg["dim"], cfg["num_classes"])
        self.transport = (autotune_transport(self.n, self.schedule.n_communication_atoms, self.P,
                                             device=dev)
                          if cfg["transport"] == "auto" else cfg["transport"])
        self.kw = dict(model=cfg["model"], steps=self.steps,
                       batch_size=cfg["batch_size"], lr=cfg["lr"], eval_every=tr["eval_every"],
                       X_test=self.X_test, y_test=self.y_test, seed=ctx.seed, device=dev,
                       params0=self.params0, schedule=self.schedule, transport=cfg["transport"])

    def offset(self, c: int) -> int:
        return (c * _OFFSET_STRIDE) % (self.spare + 1)

    def call(self, c: int, tracer=None, steps: int | None = None):
        """Call ``c`` of the port (of ``steps``, the cell's by default): a
        MetricLogger."""
        from repro_torch.train.trainer import run_classification

        o, steps = self.offset(c), steps or self.steps
        return run_classification(self.X, self.y, self.nodes, self.result.W,
                                  batch_indices=self.pool[o:o + steps], tracer=tracer,
                                  **dict(self.kw, steps=steps))

    def reference(self, c: int, prec: str = "float32", fault: str | None = None) -> dict:
        """Call ``c`` as the plain reference computes it, its topology learnt
        again from Pi (``fault``: one planted, ``reference/linear_dsgd.py``)."""
        cfg, dev = self.ctx.config, self.ctx.device
        coeffs, perms, _ = stlfw.learn(self.Pi, self.ctx.traffic["budget"], cfg["lam"])
        o = self.offset(c)
        return linear_dsgd.run(
            torch.as_tensor(self.X, device=dev), torch.as_tensor(self.y, device=dev).long(),
            self.nodes, stlfw.matrix(coeffs, perms), self.params0,
            self.pool[o:o + self.steps].to(dev), cfg["lr"], self.ctx.traffic["eval_every"],
            torch.as_tensor(self.X_test, device=dev),
            torch.as_tensor(self.y_test, device=dev).long(), prec, fault)


def answer(log) -> dict:
    """What a call says: its losses, and its evaluations."""
    evals = [(r["step"], r["acc_mean"], r["acc_min"], r["acc_max"], r["consensus"])
             for r in log.history if "acc_mean" in r]
    return {"losses": np.asarray(log.column("loss"), np.float64), "evals": evals}


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: the widest gap of a step's loss (nats) and of
    the consensus distance at an evaluation (share of the reference's)."""
    inf = float("inf")
    lp, lr = got["losses"], ref["losses"]
    loss_gap = float(np.max(np.abs(lp - lr))) if lp.shape == lr.shape else inf
    ep, er = got["evals"], ref["evals"]
    if [e[0] for e in ep] != [e[0] for e in er]:
        return {"loss_gap": loss_gap, "consensus_gap": inf}
    cons = max(abs(p[4] - r[4]) / r[4] for p, r in zip(ep, er))
    return {"loss_gap": loss_gap, "consensus_gap": float(cons)}



def run(ctx: Context) -> Outcome:
    from repro_torch.obs.trace import Tracer

    dev = ctx.device
    precision.no_tf32()
    sim = Sim(ctx)
    ctx.say(f"# transport {sim.transport}; lmo {sim.result.lmo_backend}; atoms "
            f"{sim.schedule.n_atoms} ({sim.schedule.n_communication_atoms} communicating); "
            f"stlfw_s {sim.stlfw_s:.3f}")
    with ctx.spans.span("bench.setup.warmup"):
        # two evaluation periods run every body shape of a call: one step,
        # then bodies of 64 steps and the remainders of eval_every and of
        # eval_every - 1
        sim.call(0, steps=min(sim.steps, 2 * ctx.traffic["eval_every"]))
        sync(dev)
    if ctx.trace:  # the profiler's own start-up stays out of the traced call
        with torch.profiler.profile(activities=profiler_activities(dev)):
            torch.ones(1, device=dev).add_(1)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    answers, captures, segments, call_s = [], [], [], []
    t0 = time.perf_counter()
    c, failed = 1, 0
    while True:
        tracer = Tracer() if ctx.trace else None
        with ctx.spans.span("bench.call", index=c):
            try:
                log = sim.call(c, tracer)
            except RuntimeError as exc:
                failed += 1
                ctx.say(f"# call {c} failed: {exc!r}")
                break
        call_s.append(ctx.spans.records[-1].seconds)
        answers.append((c, answer(log)))
        captures.append(log.aux["n_traces"])
        if tracer is not None:
            segments += [(sp.duration_s, sp.attrs["k"]) for sp in tracer.spans("sim.segment")]
        c += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    steps_done = len(answers) * sim.steps
    ctx.say(f"# window {window_s:.3f} s, {len(answers)} calls of {sim.steps} steps; "
            f"captures a call {captures}; seconds a call {[round(s, 3) for s in call_s]}")

    trace = None
    if ctx.trace:
        ctx.spans.profiling = True
        with torch.profiler.profile(activities=profiler_activities(dev)) as prof:
            with ctx.spans.span("bench.traced"):
                sim.call(c, Tracer())
                sync(dev)
        ctx.spans.profiling = False
        trace = read_trace(prof, "bench.traced")
        del prof
    peak = max(setup_peak, torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    ctx.say(f"# memory peak {peak} bytes")

    # the reference, once the window has closed and the port's state is freed
    pick = int(np.random.default_rng(ctx.seed).integers(len(answers))) if answers else 0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = []
    if answers:
        c_pick, got = answers[pick]
        ctx.say(f"# compared: call {c_pick} of the window")
        checks = gap_checks(compare(got, sim.reference(c_pick)), ctx.traffic["limits"])
    else:
        checks = gap_checks({}, ctx.traffic["limits"])

    cfg = ctx.config
    nnz = int(np.count_nonzero(sim.result.W > 1e-12))
    flops = linear.train_flops_per_step(sim.n, cfg["batch_size"], cfg["dim"], cfg["num_classes"])
    return Outcome(
        attempted=len(answers) + failed, failed=failed,
        end_to_end={"sim_steps_per_s": steps_done / window_s},
        layer={"segments": segments, "captures": captures, "stlfw_s": sim.stlfw_s,
               "model_flops_per_s": flops * steps_done / window_s, "mfu_peak": "tf32_flops_per_s",
               "traced_steps": sim.steps,
               "mix_least_s_per_step": gossip.mix_least_s(
                   sim.n, sim.P, 4, 4 * sim.schedule.n_atoms * (sim.n + 1), nnz, ctx.peaks)},
        checks=checks, memory_peak_bytes=int(peak), window_start=t0, trace=trace)


def calibrate(ctx: Context, modes: list[str]) -> dict:
    """The numbers compared, for one seed, of the port (``"program"``), of
    the control (``"control"``: the reference in TF32, in the port's place)
    and of each fault planted in the reference in the port's place
    (``"fault:<name>"``), each against the float32 reference; call 1 of the
    window."""
    precision.no_tf32()
    sim = Sim(ctx)
    tic = time.perf_counter()
    ref = sim.reference(1)
    out = {"reference_s": time.perf_counter() - tic, "transport": sim.transport}
    if "program" in modes:
        out["program"] = compare(answer(sim.call(1)), ref)
    if "control" in modes:
        out["control"] = compare(sim.reference(1, "tf32"), ref)
    for mode in modes:
        if mode.startswith("fault:"):
            out[mode] = compare(sim.reference(1, fault=mode[len("fault:"):]), ref)
    return out
