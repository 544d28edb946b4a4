"""Run a job on n gloo ranks of the CPU, for the port's rank tests.

``spawn_ranks(n, job, tmp_path, *args)`` starts n spawn-context processes
that each cap torch at one thread, join a gloo group through a file under
``tmp_path`` (no TCP port, so parallel test workers never collide), run
``job(rank, n, *args)`` from this module and save what it returns; the
parent joins them with a time limit, kills what is left, and returns the
results in rank order or raises with the failed ranks' tracebacks.

This module imports torch and the port only, never jax: the rank
processes import it (``tests/test_torch_standalone.py`` checks that they
load no jax).
"""

from __future__ import annotations

import datetime
import os
import sys
import time
import traceback

import numpy as np

JOIN_TIMEOUT_S = 240


def _rank_main(rank: int, n: int, init: str, job_name: str, args: tuple, out: str) -> None:
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=60))
        result = globals()[job_name](rank, n, *args)
        result["_jax_loaded"] = "jax" in sys.modules
        torch.save(result, f"{out}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(n: int, job, tmp_path, *args, timeout: float = JOIN_TIMEOUT_S) -> list[dict]:
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    tag = f"{job.__name__}_{n}_{time.monotonic_ns()}"
    init = f"file://{tmp_path}/{tag}.rendezvous"
    outs = [os.path.join(str(tmp_path), f"{tag}.rank{r}") for r in range(n)]
    procs = [ctx.Process(target=_rank_main, args=(r, n, init, job.__name__, args, outs[r]))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    errors = [open(f"{o}.err").read() for o in outs if os.path.exists(f"{o}.err")]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{job.__name__} on {n} ranks: hung {hung}, exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errors)[-6000:])
    return [torch.load(f"{o}.pt", weights_only=False) for o in outs]


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

def _tree(arrays: dict, prefix: str, rank: int | None = None, bf16_h: bool = True):
    """The ``prefix/<leaf>`` entries of ``arrays`` as a dict of tensors
    (this rank's row when ``rank`` is given); ``h`` is bfloat16 in a
    parameter state (``bf16_h``), float32 in an EF memory."""
    import torch

    out = {}
    for key, value in arrays.items():
        if key.startswith(prefix + "/"):
            leaf = key[len(prefix) + 1:]
            t = torch.as_tensor(value if rank is None else value[rank])
            out[leaf] = t.to(torch.bfloat16) if leaf == "h" and bf16_h else t
    return out


def _np(tree) -> dict:
    import torch

    return {k: v.to(torch.float32).numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in tree.items()}


def transports_job(rank: int, n: int, inputs_path: str, table_path: str) -> dict:
    """Every rank transport on this rank's row of the inputs the
    reference ran on; returns ``{name: {leaf: this rank's output}}``,
    the bytes counted, and the measured autotune record."""
    import torch

    from repro_torch.core import compression as C
    from repro_torch.core import mixing as M
    from repro_torch.core.dsgd import DSGDState, dsgd_step_sharded

    with np.load(inputs_path) as f:
        arr = {k: f[k] for k in f.files if k.startswith(f"{n}/")}
    arr = {k[len(f"{n}/"):]: v for k, v in arr.items()}
    p0, p1 = (_tree(arr, name, rank) for name in ("p0", "p1"))
    e0 = _tree(arr, "e0", rank, bf16_h=False)
    pool = M.PermPool(perms=tuple(tuple(int(x) for x in row) for row in arr["pool_perms"]))
    gammas = torch.as_tensor(arr["gammas"])
    arrays = pool.arrays_for(arr["gammas"], device="cpu")
    W = torch.as_tensor(arr["W"])
    sched = M.BirkhoffSchedule(coeffs=tuple(float(c) for c in arr["gammas"]),
                               perms=pool.perms)
    delays = torch.as_tensor(arr["delays"])
    zeros = torch.zeros_like(delays)
    corrupt = M.WireCorruption(mult=torch.as_tensor(arr["mult"]),
                               xor=torch.as_tensor(arr["xor"]))
    out: dict = {}

    def stale():
        return M.shard_stale_init(p0, 2)

    M.reset_collective_bytes()
    out["dense"] = M.mix_dense_sharded(p1, W)
    ag_bytes = M.collective_bytes["all_gather"]
    out["arrays"] = M.mix_arrays_sharded(p1, arrays)
    M.reset_collective_bytes()
    out["pool"] = M.mix_ppermute_pool(p1, gammas, pool)
    pool_bytes = M.collective_bytes["ppermute"]
    out["ppermute"] = M.mix_ppermute(p1, sched)
    out["allreduce"] = M.mix_allreduce(p1)
    out["dense_corrupt"] = M.mix_dense_sharded(p1, W, corrupt=corrupt)
    out["arrays_corrupt"] = M.mix_arrays_sharded(p1, arrays, corrupt=corrupt)
    out["pool_corrupt"] = M.mix_ppermute_pool(p1, gammas, pool, corrupt=corrupt)
    out["arrays_stale"], _ = M.mix_arrays_sharded_stale(p1, stale(), arrays, delays)
    out["pool_stale"], _ = M.mix_ppermute_pool_stale(p1, stale(), gammas, pool, delays)
    out["arrays_stale_corrupt"], _ = M.mix_arrays_sharded_stale(p1, stale(), arrays, delays,
                                                                corrupt=corrupt)
    out["pool_stale_corrupt"], _ = M.mix_ppermute_pool_stale(p1, stale(), gammas, pool, delays,
                                                              corrupt=corrupt)
    out["arrays_stale0"], st = M.mix_arrays_sharded_stale(p1, stale(), arrays, zeros)
    out["stale_ring_head"] = {"head": st.head.reshape(1)}
    out["pool_stale0"], _ = M.mix_ppermute_pool_stale(p1, stale(), gammas, pool, zeros)
    for wire in ("bf16", "topk:0.5", "identity"):
        w = wire.split(":")[0]
        out[f"ef_{w}_arrays"], out[f"ef_{w}_arrays_e"] = C.mix_arrays_sharded_ef(
            p1, e0, arrays, None, wire)
        out[f"ef_{w}_dense"], out[f"ef_{w}_dense_e"] = C.mix_dense_sharded_ef(
            p1, e0, W, None, wire)
        out[f"ef_{w}_pool"], out[f"ef_{w}_pool_e"] = C.mix_ppermute_pool_ef(
            p1, e0, gammas, pool, None, wire)
        out[f"ef_{w}_arrays_stale"], out[f"ef_{w}_arrays_stale_e"], _ = \
            C.mix_arrays_sharded_stale_ef(p1, e0, stale(), arrays, delays, None, wire)
        out[f"ef_{w}_pool_stale"], out[f"ef_{w}_pool_stale_e"], _ = \
            C.mix_ppermute_pool_stale_ef(p1, e0, stale(), gammas, pool, delays, None, wire)
        out[f"ef_{w}_arrays_stale0"], _, _ = C.mix_arrays_sharded_stale_ef(
            p1, e0, stale(), arrays, zeros, None, wire)
        out[f"ef_{w}_pool_stale0"], _, _ = C.mix_ppermute_pool_stale_ef(
            p1, e0, stale(), gammas, pool, zeros, None, wire)
    out["ef_bf16_arrays_corrupt"], _ = C.mix_arrays_sharded_ef(p1, e0, arrays, None, "bf16",
                                                               corrupt=corrupt)
    out["ef_bf16_pool_corrupt"], _ = C.mix_ppermute_pool_ef(p1, e0, gammas, pool, None, "bf16",
                                                            corrupt=corrupt)
    # a bfloat16 ring holds what a float32 ring does for bf16 leaves
    h0, h1, eh = {"h": p0["h"]}, {"h": p1["h"]}, {"h": e0["h"]}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        out[f"ring_{tag}_arrays"], _ = M.mix_arrays_sharded_stale(
            h1, M.shard_stale_init(h0, 2, dt), arrays, delays)
        out[f"ring_{tag}_pool"], _ = M.mix_ppermute_pool_stale(
            h1, M.shard_stale_init(h0, 2, dt), gammas, pool, delays)
        out[f"ring_{tag}_ef_arrays"], _, _ = C.mix_arrays_sharded_stale_ef(
            h1, eh, M.shard_stale_init(h0, 2, dt), arrays, delays, None, "bf16")
        out[f"ring_{tag}_ef_pool"], _, _ = C.mix_ppermute_pool_stale_ef(
            h1, eh, M.shard_stale_init(h0, 2, dt), gammas, pool, delays, None, "bf16")
    state = DSGDState(step=0, momentum=None)
    out["dsgd_schedule"], s1 = dsgd_step_sharded(p1, p0, state, sched, None, lr=0.1)
    out["dsgd_complete"], _ = dsgd_step_sharded(p1, p0, state, None, None, lr=0.1)
    result = {name: _np(tree) for name, tree in out.items()}
    result["_bytes"] = {"all_gather": ag_bytes, "ppermute": pool_bytes, "dsgd_step": s1.step}
    os.environ["REPRO_TORCH_TRANSPORT_AUTOTUNE"] = table_path
    result["_autotune"] = M.autotune_sharded_transport(n, pool.n_comm_slots, 64, measure=True,
                                                       device="cpu")
    result["_lookup"] = M.autotune_sharded_transport(n, pool.n_comm_slots, 60, device="cpu")
    return result


def _lm_arm_setup(arm: dict, lr: float, pools: list, schedule, cfg, extra=None):
    """The port's ``make_train_setup`` for one arm of ``test_torch_lm_ranks``."""
    import torch.distributed as dist

    from repro_torch.core.mixing import StragglerPolicy
    from repro_torch.obs import HealthProbes
    from repro_torch.train.lm_trainer import make_train_setup

    kw = dict(arm)
    kw.pop("run", None)
    kw.pop("quarantine", None)
    online = kw.pop("online_w", None)
    if kw.pop("schedule", False):
        kw["schedule"] = schedule
    if online == "pool":
        kw["pool"] = pools[0]
    if "staleness" in kw:
        kw["staleness"] = StragglerPolicy(*kw["staleness"])
    if kw.pop("probes", False):
        kw["probes"] = HealthProbes(consensus=True, grad_dev=True)
    kw.update(extra or {})
    return make_train_setup(cfg, group=dist.group.WORLD, online_w=online is not None, lr=lr,
                            device="cpu", **kw), online


class _Quarantine:
    """A quarantine controller's accounting face: node 1 isolated."""

    def mask(self):
        return np.array([False, True, False, False])

    def summary(self):
        return {"isolated": [1]}


def lm_ranks_job(rank: int, n: int, ref_path: str, arms: dict, lr: float, ckpt: str) -> dict:
    """Every arm of ``test_torch_lm_ranks`` on this rank: 3 ``train_step``
    calls (or the ``run_segments`` drill) from this rank's row of the
    reference's initial parameters; plus the port's own claims."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.mixing import BirkhoffSchedule, PermPool, PoolSwap, ScheduleArrays

    cfg = get_smoke_config("qwen3-0.6b")
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    init = {k[len("init/"):]: torch.as_tensor(v[rank]) for k, v in ref.items()
            if k.startswith("init/")}
    schedule = BirkhoffSchedule(coeffs=tuple(float(c) for c in ref["coeffs"]),
                                perms=tuple(tuple(int(i) for i in p) for p in ref["perms"]))
    arrays = ScheduleArrays(gammas=torch.as_tensor(ref["coeffs"], dtype=torch.float32),
                            perms=torch.as_tensor(ref["perms"], dtype=torch.int32))
    pools = [PermPool(perms=tuple(tuple(int(x) for x in p) for p in ref[f"pool{j}"]))
             for j in (0, 1)]
    toks, labels = ref["tokens"][:, rank].astype(np.int64), ref["labels"][:, rank].astype(np.int64)
    batches = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    out: dict = {}

    def operand(online):
        if online == "dense":
            return torch.as_tensor(ref["W"])
        if online == "arrays":
            return arrays
        if online == "pool":
            return torch.as_tensor(ref["gammas0"])
        return None

    def three_steps(setup, online, params):
        opt = setup.init_opt_state(params)
        losses, series = [], []
        for t in range(3):
            extra = () if online is None else (operand(online),)
            if setup.staleness is not None:
                extra = extra + (torch.as_tensor(ref["delays"][t]),)
            params, opt, loss = setup.train_step(params, opt, {k: v[t] for k, v in
                                                               batches.items()}, *extra)
            series.append({k: float(v) for k, v in loss.items()} if isinstance(loss, dict)
                          else {"loss": float(loss)})
        return params, opt, series

    def hook_for(setup):
        def hook(t):
            if t == 1:
                return PoolSwap(gammas=ref["gammas1"])
            if t == 3:
                return PoolSwap(gammas=ref["gammas2"], pool=pools[1])
            return None
        return hook

    for name, arm in arms.items():
        setup, online = _lm_arm_setup(arm, lr, pools, schedule, cfg)
        params = {k: v.clone() for k, v in init.items()}
        if arm.get("run") == "segments":
            res = setup.run_segments(params, setup.init_opt_state(params), batches,
                                     operand(online), segment_len=2, rollout="loop",
                                     on_segment=hook_for(setup),
                                     delays=ref["raw_delays"] if setup.staleness else None,
                                     quarantine=_Quarantine() if arm.get("quarantine") else None)
            out[name] = {"losses": res["losses"], "final": _np(res["params"]),
                         "health": res.get("health", {}), "quarantine": res.get("quarantine"),
                         "recompiles": res["recompiles"], "swaps": res["swaps"],
                         "comm": res["comm"], "transport": res["setup"].sharded_transport,
                         "comm_bytes": res["setup"].comm_bytes_per_step}
            continue
        p, opt, series = three_steps(setup, online, params)
        out[name] = {"series": series, "final": _np(p), "comm_bytes": setup.comm_bytes_per_step,
                     "transport": setup.sharded_transport}
        if isinstance(opt, dict) and "ef" in opt:
            out[name]["ef"] = _np(opt["ef"])
        if isinstance(opt, dict) and "stale" in opt:
            out[name]["ring"] = _np(opt["stale"]["buf"])
            out[name]["head"] = int(opt["stale"]["head"])
        if isinstance(opt, dict) and "step" in opt:
            out[name]["step"] = int(opt["step"])

    # -- the port's own claims ----------------------------------------------
    own: dict = {}
    setup, online = _lm_arm_setup(arms["pool_ef_stale"], lr, pools, schedule, cfg)
    params = {k: v.clone() for k, v in init.items()}
    opt0 = setup.init_opt_state(params)
    try:
        setup.multi_step_fn("scan")
    except ValueError as exc:
        own["scan_refused"] = str(exc)
    multi = setup.multi_step_fn("loop")
    stack = torch.as_tensor(np.stack([ref["gammas0"]] * 3))
    p_m, o_m, l_m = multi(params, opt0, {k: v[:3] for k, v in batches.items()}, stack,
                          torch.as_tensor(ref["delays"]))
    p_s, o_s, _ = setup.train_step(params, opt0, {k: v[0] for k, v in batches.items()},
                                   torch.as_tensor(ref["gammas0"]),
                                   torch.as_tensor(ref["delays"][0]))
    for t in (1, 2):
        p_s, o_s, _ = setup.train_step(p_s, o_s, {k: v[t] for k, v in batches.items()},
                                       torch.as_tensor(ref["gammas0"]),
                                       torch.as_tensor(ref["delays"][t]))
    own["loop_bitwise_steps"] = all(torch.equal(p_m[k], p_s[k]) for k in p_m) and all(
        torch.equal(o_m["ef"][k], o_s["ef"][k]) and torch.equal(
            o_m["stale"]["buf"][k], o_s["stale"]["buf"][k]) for k in p_m) and bool(
        torch.equal(o_m["stale"]["head"], o_s["stale"]["head"]))
    own["multi_losses"] = l_m.numpy()
    # a resumed run over the EF + stale carry, bitwise the uninterrupted one
    kw = dict(segment_len=2, rollout="loop", on_segment=hook_for(setup),
              delays=ref["raw_delays"])
    whole = setup.run_segments(params, opt0, batches, torch.as_tensor(ref["gammas0"]), **kw)
    # the checkpoint gathers one per-node leaf at a time, to rank 0 only,
    # and writes it before it gathers the next
    from repro_torch.train import lm_trainer

    gather, write, events = lm_trainer._gather_leaf, np.lib.format.write_array, []

    def counted_gather(x, group):
        out = gather(x, group)
        events.append(("gather", None if out is None else out.data_ptr()))
        return out

    def counted_write(f, arr, *a, **k):
        events.append(("write", arr.__array_interface__["data"][0]))
        return write(f, arr, *a, **k)

    lm_trainer._gather_leaf, np.lib.format.write_array = counted_gather, counted_write
    try:
        first = setup.run_segments(params, opt0, batches, torch.as_tensor(ref["gammas0"]),
                                   checkpoint_dir=ckpt, stop_after_segments=2, **kw)
    finally:
        lm_trainer._gather_leaf, np.lib.format.write_array = gather, write
    gathers = [k for k, (what, _) in enumerate(events) if what == "gather"]
    own["ckpt_gathers"] = {
        "calls": len(gathers), "received": sum(events[k][1] is not None for k in gathers),
        # the event after each received gather is the write of its buffer
        "written_before_next": all(events[k + 1] == ("write", events[k][1]) for k in gathers
                                   if events[k][1] is not None)}
    # the restage before the stop rebuilt the step: resume from the live setup
    rest = first["setup"].run_segments(params, opt0, batches, torch.as_tensor(ref["gammas0"]),
                                       checkpoint_dir=ckpt, resume=True, **kw)
    own["resume"] = {
        "stopped_at": first["stopped_at"], "resumed_from": rest["resumed_from"],
        "losses": bool(np.array_equal(np.concatenate([first["losses"], rest["losses"]]),
                                      whole["losses"])),
        "params": all(torch.equal(rest["params"][k], whole["params"][k]) for k in params),
        "ef": all(torch.equal(rest["opt_state"]["ef"][k], whole["opt_state"]["ef"][k])
                  for k in params),
        "ring": all(torch.equal(rest["opt_state"]["stale"]["buf"][k],
                                whole["opt_state"]["stale"]["buf"][k]) for k in params),
        "head": bool(torch.equal(rest["opt_state"]["stale"]["head"],
                                 whole["opt_state"]["stale"]["head"])),
        "recompiles": (first["recompiles"], rest["recompiles"], whole["recompiles"]),
    }
    # the checkpoint is the stacked layout: rank 0 wrote every node's row
    from repro_torch.train.checkpoints import latest_step

    import json
    import os as _os

    last = latest_step(ckpt)
    with open(_os.path.join(ckpt, f"step_{last:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    own["ckpt_shape"] = manifest["shapes"][manifest["keys"].index(
        "['params']['embed.table']")]
    # probes are bitwise the probes-off run
    on, _ = _lm_arm_setup(arms["probes"], lr, pools, schedule, cfg)
    off, _ = _lm_arm_setup(arms["probes"], lr, pools, schedule, cfg, {"probes": None})
    p_on, _, s_on = three_steps(on, "arrays", {k: v.clone() for k, v in init.items()})
    p_off, _, s_off = three_steps(off, "arrays", {k: v.clone() for k, v in init.items()})
    own["probes_bitwise"] = [a["loss"] for a in s_on] == [a["loss"] for a in s_off] and all(
        torch.equal(p_on[k], p_off[k]) for k in p_on)
    out["_own"] = own
    return out


# ---------------------------------------------------------------------------
# The mesh trainer (tests/test_torch_lm_mesh*.py, tests/_torch_mesh.py)
# ---------------------------------------------------------------------------

def _mesh_setup(arm: dict, mesh, lr: float, ref: dict, extra=None):
    """The port's ``make_train_setup`` on ``mesh`` for one arm of
    ``tests/_torch_mesh.py``; returns (setup, cfg, the arm's online kind)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.mixing import BirkhoffSchedule, PermPool, StragglerPolicy
    from repro_torch.obs import HealthProbes
    from repro_torch.train.lm_trainer import make_train_setup

    kw = dict(arm)
    cfg = get_smoke_config(kw.pop("cfg", "qwen3-0.6b"))
    for key in ("mesh", "run", "quarantine"):
        kw.pop(key, None)
    online = kw.pop("online_w", None)
    if kw.pop("schedule", False):
        kw["schedule"] = BirkhoffSchedule(coeffs=tuple(float(c) for c in ref["coeffs"]),
                                          perms=tuple(tuple(int(i) for i in p)
                                                      for p in ref["perms"]))
    if online == "pool":
        kw["pool"] = PermPool(perms=tuple(tuple(int(x) for x in p) for p in ref["pool0"]))
    if "staleness" in kw:
        kw["staleness"] = StragglerPolicy(*kw["staleness"])
    if kw.pop("probes", False):
        kw["probes"] = HealthProbes(consensus=True, grad_dev=True)
    kw.update(extra or {})
    online_w = kw.pop("online_w", online is not None)
    return make_train_setup(cfg, mesh=mesh, online_w=online_w, lr=lr, device="cpu",
                            **kw), cfg, online


def _mesh_init(setup, cfg, ref: dict) -> dict:
    """This rank's block of the reference's init: the unstacked tree
    broadcast to the node-stacked one (every node starts from it), cut by
    ``convert.lm_shard_from_numpy`` at this rank's node and coordinates."""
    import torch

    from repro_torch import convert

    prefix = f"init/{_CFG_KEYS[cfg.name]}/"
    flat = {k[len(prefix):]: torch.as_tensor(v) for k, v in ref.items() if k.startswith(prefix)}
    tree = convert.lm_stacked_to_numpy(flat, cfg, node_axis=False)
    layout = setup._layout
    if layout.node_axis is None:
        return convert.lm_shard_from_numpy(tree, cfg, setup.mesh, setup.param_specs,
                                           device="cpu")
    n = setup.n_nodes

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        if isinstance(node, list):
            return [stack(v) for v in node]
        return None if node is None else np.stack([node] * n)

    return convert.lm_shard_from_numpy(stack(tree), cfg, setup.mesh, setup.param_specs,
                                       node=layout.node, device="cpu")


_CFG_KEYS = {"qwen3-smoke": "qwen3-0.6b", "qwen3-moe-smoke": "qwen3-moe-30b-a3b"}


def _mesh_batch(ref: dict, mode: str, t) -> dict:
    import torch

    toks, labels = ref["tokens"][t].astype(np.int64), ref["labels"][t].astype(np.int64)
    if mode == "fsdp":
        toks, labels = (x.reshape((-1,) + x.shape[-1:]) if isinstance(t, int) else
                        x.reshape(x.shape[:1] + (-1,) + x.shape[-1:]) for x in (toks, labels))
    return {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}


def lm_mesh_job(rank: int, n: int, ref_path: str, arms: dict, lr: float, ckpt: str,
                own: tuple) -> dict:
    """Every arm of ``tests/_torch_mesh.py`` on this rank (3 ``train_step``
    calls, or the ``run_segments`` drill), from its block of the
    reference's init; plus the port's own claims named in ``own``."""
    import torch

    from repro_torch.core import mixing as M
    from repro_torch.core.mixing import PermPool, PoolSwap, ScheduleArrays
    from repro_torch.train import sharding
    from repro_torch.train.mesh_layout import MeshLayout

    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    meshes: dict = {}
    arrays = ScheduleArrays(gammas=torch.as_tensor(ref["coeffs"], dtype=torch.float32),
                            perms=torch.as_tensor(ref["perms"], dtype=torch.int32))
    pool1 = PermPool(perms=tuple(tuple(int(x) for x in p) for p in ref["pool1"]))

    def mesh_of(shape):
        shape = tuple(shape)
        if shape not in meshes:
            names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
            meshes[shape] = sharding.make_mesh(shape, names)
        return meshes[shape]

    def operand(online):
        return {"dense": torch.as_tensor(ref["W"]), "arrays": arrays,
                "pool": torch.as_tensor(ref["gammas0"])}.get(online)

    def hook_for(online):
        def hook(t):
            if online == "pool":
                return {1: PoolSwap(gammas=ref["gammas1"]),
                        3: PoolSwap(gammas=ref["gammas2"], pool=pool1)}.get(t)
            return torch.as_tensor(ref["W2"]) if t == 1 else None
        return hook

    def three_steps(setup, mode, online, params):
        opt = setup.init_opt_state(params)
        series = []
        for t in range(3):
            extra = () if online is None else (operand(online),)
            if setup.staleness is not None:
                extra = extra + (torch.as_tensor(ref["delays"][t]),)
            params, opt, loss = setup.train_step(
                params, opt, setup.local_batch(_mesh_batch(ref, mode, t)), *extra)
            series.append({k: float(v) for k, v in loss.items()} if isinstance(loss, dict)
                          else {"loss": float(loss)})
        return params, opt, series

    class Quarantine:  # node 1 isolated: the meter's quarantined bytes
        def mask(self):
            return np.array([False, True])

        def summary(self):
            return {"isolated": [1]}

    def segments(setup, mode, online, params, mix=None, quarantine=False, **kw):
        batches = setup.local_batch(_mesh_batch(ref, mode, slice(None)), lead=1)
        mix = operand(online) if mix is None else mix
        return setup.run_segments(params, setup.init_opt_state(params), batches, mix,
                                  segment_len=2, rollout="loop", on_segment=hook_for(online),
                                  delays=ref["raw_delays"] if setup.staleness else None,
                                  quarantine=Quarantine() if quarantine else None, **kw)

    out: dict = {"_rank": rank}
    for name, arm in arms.items():
        mesh = mesh_of(arm["mesh"])
        setup, cfg, online = _mesh_setup(arm, mesh, lr, ref)
        mode = arm.get("mode", "dsgd")
        layout = setup._layout
        params = _mesh_init(setup, cfg, ref)
        row = {"node": layout.node, "coords": layout.coords, "sizes": layout.sizes,
               "specs": setup.param_specs, "comm_bytes": setup.comm_bytes_per_step,
               "transport": setup.sharded_transport}
        if arm.get("run") == "segments":
            res = segments(setup, mode, online, params, quarantine=arm.get("quarantine", False))
            row.update({"losses": res["losses"], "final": _np(res["params"]),
                        "health": res.get("health", {}), "recompiles": res["recompiles"],
                        "swaps": res["swaps"], "comm": res["comm"],
                        "quarantine": res.get("quarantine")})
        else:
            p, opt, series = three_steps(setup, mode, online, params)
            row.update({"series": series, "final": _np(p)})
            if isinstance(opt, dict) and "ef" in opt:
                row["ef"] = _np(opt["ef"])
            if isinstance(opt, dict) and "stale" in opt:
                row["ring"] = _np(opt["stale"]["buf"])
                row["head"] = int(opt["stale"]["head"])
        out[name] = row

    mine: dict = {}
    if "no_param_gather" in own:
        # the tensor-parallel pass: every all-gather / gather call's input
        # against the parameters' storage
        import torch.distributed as dist

        for name in own["no_param_gather"]:
            arm = arms[name]
            setup, cfg, _ = _mesh_setup(arm, mesh_of(arm["mesh"]), lr, ref)
            params = _mesh_init(setup, cfg, ref)
            ptrs = {v.untyped_storage().data_ptr() for v in params.values()}
            shapes = {tuple(v.shape) for v in params.values()}
            calls = []
            real = {k: getattr(dist, k) for k in ("all_gather_into_tensor", "all_gather",
                                                  "gather")}

            def spy(kind):
                def call(*a, **k):
                    src = a[1] if kind != "gather" else a[0]
                    calls.append((kind, src.untyped_storage().data_ptr() in ptrs,
                                  tuple(src.shape)))
                    return real[kind](*a, **k)
                return call

            M.reset_collective_bytes()
            for k in real:
                setattr(dist, k, spy(k))
            try:
                loss, _ = setup.grad_fn(params, setup.local_batch(_mesh_batch(ref, "dsgd", 0)))
            finally:
                for k, v in real.items():
                    setattr(dist, k, v)
            mine.setdefault("no_param_gather", {})[name] = {
                "gathers": calls, "param_shapes": shapes, "calls": dict(M.collective_calls),
                "loss": float(loss)}
    if "dtensor_blocks" in own:
        # a rank's block of every leaf is DTensor's local shard under the
        # spec's placements, on the mesh of each mode
        from torch.distributed.tensor import distribute_tensor

        same = {}
        for name in own["dtensor_blocks"]:
            arm = arms[name]
            mesh = mesh_of(arm["mesh"])
            setup, cfg, _ = _mesh_setup(arm, mesh, lr, ref)
            full = {k[len(f"init/{_CFG_KEYS[cfg.name]}/"):]: torch.as_tensor(v)
                    for k, v in ref.items() if k.startswith(f"init/{_CFG_KEYS[cfg.name]}/")}
            shardings = sharding.make_param_shardings(setup.param_specs, mesh)
            same[name] = all(torch.equal(
                distribute_tensor(v, mesh, shardings[k]).to_local(), setup._layout.shard(v, k))
                for k, v in full.items())
        mine["dtensor_blocks"] = same
    if "planted_probe_fault" in own:
        # a replicated leaf summed over model as if split: the probes count
        # it TP times
        arm = arms["probes"]
        real = MeshLayout.model_split
        MeshLayout.model_split = lambda self, name: True
        try:
            setup, cfg, online = _mesh_setup(arm, mesh_of(arm["mesh"]), lr, ref)
            _, _, series = three_steps(setup, "dsgd", online, _mesh_init(setup, cfg, ref))
        finally:
            MeshLayout.model_split = real
        mine["planted_probe_fault"] = series
    if "refusals" in own:
        refused = {}
        arm = arms[own["refusals"]]
        setup, cfg, _ = _mesh_setup(arm, mesh_of(arm["mesh"]), lr, ref, {"online_w": True})
        params = _mesh_init(setup, cfg, ref)
        try:
            setup.train_step(params, None, setup.local_batch(_mesh_batch(ref, "dsgd_pod", 0)),
                             arrays)
        except TypeError as exc:
            refused["pod_arrays"] = str(exc)
        try:
            setup.multi_step_fn("scan")
        except ValueError as exc:
            refused["scan"] = str(exc)
        mine["refusals"] = refused
    if "resume" in own:
        arm = arms[own["resume"]]
        setup, cfg, online = _mesh_setup(arm, mesh_of(arm["mesh"]), lr, ref)
        params = _mesh_init(setup, cfg, ref)
        whole = segments(setup, "dsgd", online, params)
        first = segments(setup, "dsgd", online, params, checkpoint_dir=ckpt,
                         stop_after_segments=2)
        # the restage before the stop rebuilt the step: resume from the live
        # setup, with an operand of its pool (the checkpoint's replaces it)
        rest = segments(first["setup"], "dsgd", online, params,
                        mix=torch.as_tensor(ref["gammas2"]), checkpoint_dir=ckpt, resume=True)
        import json
        import os as _os

        from repro_torch.train.checkpoints import latest_step

        last = latest_step(ckpt)
        with open(_os.path.join(ckpt, f"step_{last:08d}", "manifest.json")) as f:
            manifest = json.load(f)
        mine["resume"] = {
            "stopped_at": first["stopped_at"], "resumed_from": rest["resumed_from"],
            "losses": bool(np.array_equal(np.concatenate([first["losses"], rest["losses"]]),
                                          whole["losses"])),
            "params": all(torch.equal(rest["params"][k], whole["params"][k]) for k in params),
            "ckpt_shape": manifest["shapes"][manifest["keys"].index(
                "['params']['embed.table']")],
            "local_shape": list(params["embed.table"].shape)}
    out["_own"] = mine
    return out


def mesh_import_job(rank: int, n: int) -> dict:
    """One tensor-parallel dsgd step of qwen3's smoke config on a (1, n)
    mesh: what a rank process of the mesh trainer imports."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.train.lm_trainer import make_train_setup
    from repro_torch.train.sharding import make_mesh

    cfg = get_smoke_config("qwen3-0.6b")
    setup = make_train_setup(cfg, mesh=make_mesh((1, n), ("data", "model")), device="cpu")
    params = setup.init_params(0)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "labels": torch.ones((1, 8), dtype=torch.long)}
    _, _, loss = setup.train_step(params, None, batch)
    return {"loss": float(loss), "modules": sorted(m for m in sys.modules
                                                   if m.startswith("repro_torch.train"))}


# ---------------------------------------------------------------------------
# Tensor parallelism of every family (tests/test_torch_lm_mesh_families.py)
# ---------------------------------------------------------------------------

def _latent_per_rank(c_local, norm, eps, tp, split):
    """A planted fault: MLA's split latent normalised on each rank's block
    (its own sum of squares), then gathered."""
    import types

    from repro_torch.models.layers import rms_norm
    from repro_torch.train import tensor_parallel as T

    if not split:
        return rms_norm(types.SimpleNamespace(scale=T.copy_to(norm.scale, tp)), c_local, eps)
    c = rms_norm(types.SimpleNamespace(scale=T.slice_last(norm.scale, tp)), c_local, eps)
    return T.gather_last_partial(c, tp)


def _branch_cut(x_local, tp):
    """A planted fault: the recurrent branch the gates read cut to this
    rank's features (the other ranks' blocks zero)."""
    import torch

    from repro_torch.train import tensor_parallel as T

    full = T.gather_last_partial(x_local, tp)
    w = x_local.shape[-1]
    keep = torch.zeros(full.shape[-1], dtype=full.dtype, device=full.device)
    keep[tp.rank * w:(tp.rank + 1) * w] = 1
    return full * keep


# planted in repro_torch.models.parallel, whose functions the blocks call
_FAULTS = {"latent_per_rank": ("latent_norm", _latent_per_rank),
           "gates_cut_per_rank": ("branch", _branch_cut)}


def lm_families_job(rank: int, n: int, ref_path: str, arms: dict, lr: float, steps: int,
                    faults: dict) -> dict:
    """Every arm of ``test_torch_lm_mesh_families`` on this rank: its blocks
    of the reference's init on the arm's ``(data, model)`` mesh, the
    gradient at init (``grad_fn``, the node's first batch), ``steps``
    ``train_step`` calls; the plan, the gathers' sources, and the planted
    faults' losses and gradients."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mixing as M
    from repro_torch.models import parallel
    from repro_torch.train import sharding
    from repro_torch.train.lm_trainer import make_train_setup

    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    meshes: dict = {}
    out: dict = {"_rank": rank}

    def batch_at(name, t):
        b = {"tokens": ref[f"{name}/tokens"][t].astype(np.int64),
             "labels": ref[f"{name}/labels"][t].astype(np.int64)}
        if f"{name}/frames" in ref:
            b["frames"] = ref[f"{name}/frames"][t]
        return {k: torch.as_tensor(v) for k, v in b.items()}

    for name, arm in arms.items():
        shape = tuple(arm["mesh"])
        if shape not in meshes:
            meshes[shape] = sharding.make_mesh(shape, ("data", "model"))
        cfg = dataclasses.replace(get_smoke_config(arm["cfg"]), **arm.get("over", {}))
        setup = make_train_setup(cfg, mesh=meshes[shape], lr=lr, device="cpu")
        layout = setup._layout
        prefix = f"{name}/init/"
        params = {k[len(prefix):]: layout.shard(torch.as_tensor(v), k[len(prefix):])
                  for k, v in ref.items() if k.startswith(prefix)}
        ptrs = {v.untyped_storage().data_ptr() for v in params.values()}
        first = setup.local_batch(batch_at(name, 0))
        real, gathers = dist.all_gather_into_tensor, []

        def spy(dst, src, *a, **k):
            gathers.append(src.untyped_storage().data_ptr() in ptrs)
            return real(dst, src, *a, **k)

        M.reset_collective_bytes()
        dist.all_gather_into_tensor = spy
        try:
            loss0, grads = setup.grad_fn(params, first)
        finally:
            dist.all_gather_into_tensor = real
        calls = {k: v for k, v in M.collective_calls.items() if v}
        p, losses = params, []
        for t in range(steps):
            p, _, loss = setup.train_step(p, None, setup.local_batch(batch_at(name, t)))
            losses.append(float(loss))
        plan = setup._core.plan
        row = {"node": layout.node, "coords": layout.coords, "sizes": layout.sizes,
               "specs": setup.param_specs, "grad_loss": float(loss0), "grads": _np(grads),
               "final": _np(p), "losses": losses, "vocab": plan.vocab,
               "layers": [{k: dict(v) if hasattr(v, "items") else v for k, v in lp.items()}
                          for lp in plan.layers + plan.enc_layers],
               "gathered_params": sum(gathers), "gathers": len(gathers), "calls": calls}
        for fault in faults.get(name, ()):
            attr, fn = _FAULTS[fault]
            saved = getattr(parallel, attr)
            setattr(parallel, attr, fn)
            try:
                floss, fgrads = setup.grad_fn(params, first)
            finally:
                setattr(parallel, attr, saved)
            row[f"fault/{fault}"] = {"loss": float(floss), "grads": _np(fgrads)}
        out[name] = row
    return out


def _serve_cfg(arm: dict):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arm["cfg"]), **arm.get("over", {}))


def serve_inputs(arm: dict, B: int, S: int, steps: int) -> dict:
    """An arm's numpy inputs from its seed: the prompt (B, S), the decode
    steps' tokens (steps, B, 1), whisper's stub frames N(0, 0.1)."""
    cfg = _serve_cfg(arm)
    rng = np.random.default_rng(arm.get("seed", 3))
    out = {"prompt": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64),
           "steps": rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int64)}
    if cfg.arch_type == "audio":
        out["frames"] = rng.normal(0.0, 0.1, (B, cfg.encoder.num_frames, cfg.d_model)).astype(
            np.float32)
    return out


def serve_mesh_job(rank: int, n: int, arms: dict, B: int, S: int, steps: int,
                   max_len: int) -> dict:
    """Every arm of ``test_torch_serve_mesh`` on this rank: the smoke
    model from seed 0 (``registry.init_model``), this rank's blocks of its
    reference pytree (``convert.lm_shard_from_numpy`` by the setup's
    specs), the sharded prefill of the arm's prompt into a fresh cache
    block, ``steps`` ``serve_step`` calls, then the same steps through a
    ``MeshDecoder`` from a second prefill; returns the logits (this rank's
    rows), the cache blocks, the collective counters and the bytes the
    step takes."""
    import torch

    from repro_torch import convert
    from repro_torch.core import mixing as M
    from repro_torch.models import registry
    from repro_torch.serve.engine import make_serve_setup
    from repro_torch.train import sharding

    out: dict = {"_rank": rank}
    meshes: dict = {}
    for name, arm in arms.items():
        shape = tuple(arm["mesh"])
        if shape not in meshes:
            meshes[shape] = sharding.make_mesh(shape, ("data", "model"))
        mesh = meshes[shape]
        cfg = _serve_cfg(arm)
        long = arm.get("long", False)
        setup = make_serve_setup(cfg, mesh, batch=B, seq_len=max_len, long_context=long,
                                 device="cpu")
        model = registry.init_model(cfg, seed=0, device="cpu")
        params = convert.lm_shard_from_numpy(convert.lm_params_to_numpy(model), cfg, mesh,
                                             setup.param_specs, device="cpu")
        del model
        inp = {k: torch.as_tensor(v) for k, v in serve_inputs(arm, B, S, steps).items()}
        kw = {"frames": setup.local_batch(inp["frames"])} if "frames" in inp else {}
        prompt = setup.local_batch(inp["prompt"])
        cache = setup.init_cache()
        logits = [setup.prefill(params, prompt, cache, **kw)]
        M.reset_collective_bytes()
        token = setup.local_batch(inp["steps"][0])
        position = torch.full_like(token, S)
        arg_bytes = sum(v.numel() * v.element_size() for v in params.values()) + \
            sum(v.numel() * v.element_size() for v in _cache_leaves(cache)) + \
            token.numel() * token.element_size() + position.numel() * position.element_size()
        for t in range(steps):
            lo, cache = setup.serve_step(params, setup.local_batch(inp["steps"][t]),
                                         torch.full_like(token, S + t), cache)
            if t == 0:
                first = {k: int(v) for k, v in M.collective_bytes.items() if v}
            logits.append(lo)
        dec = setup.decoder(params, setup.init_cache())
        dec.start(prompt, **kw)
        dec_logits = []
        for t in range(steps):
            dec.step(setup.local_batch(inp["steps"][t]))
            dec_logits.append(dec.logits.clone())
        out[name] = {
            "coords": sharding.mesh_coords(mesh), "sizes": sharding.mesh_sizes(mesh),
            "logits": [x.numpy() for x in logits],
            "decoder_logits": [x.numpy() for x in dec_logits], "captures": dec.n_captures,
            "cache": [(path, spec, t.numpy()) for path, spec, t in
                      _cache_items(cache, setup.cache_specs)],
            "step_bytes": first, "argument_bytes": arg_bytes,
            "param_specs": setup.param_specs}
    return out


def _cache_leaves(cache) -> list:
    return [t for _, _, t in _cache_items(cache, None)]


def _cache_items(cache, specs) -> list:
    """``(path, spec, tensor)`` of every tensor of a cache: ``(i, leaf)`` a
    layer's, ``("encoder_out",)``, ``("self", i, leaf)`` whisper's."""
    import torch

    items = []
    if isinstance(cache, dict):
        items.append((("encoder_out",), specs and specs["encoder_out"], cache["encoder_out"]))
        layers, pre = cache["self"], ("self",)
        lspecs = specs["self"] if specs else None
    else:
        layers, pre, lspecs = cache, (), specs
    for i, d in enumerate(layers):
        for k, v in d.items():
            if isinstance(v, torch.Tensor):
                items.append((pre + (i, k), lspecs[i][k] if lspecs else None, v))
    return items
