"""The port's LM trainer (``repro_torch.train.lm_trainer``) against the
reference's mesh trainer.

The reference runs in ONE module-scoped subprocess with 8 forced host
devices, on a ``(4, 2)`` ``("data", "model")`` mesh as
``tests/test_distributed.py`` builds it: each arm's ``make_train_setup``
step, jitted, takes 3 steps from the reference's own ``init_params`` on
the same numpy batches, and the subprocess writes the per-step losses,
the final stacked parameters (through ``convert.lm_stacked_from_numpy``,
so named as the port's), the initial ones and the STL-FW schedule to an
``.npz`` under ``tmp_path``. The port then runs each arm with 4 stacked
nodes on the CPU (where the mix sums in the leaf dtype: the reference's)
from those initial parameters.

Arms: a static STL-FW schedule (``learn_topology`` on a 2-domain Pi,
budget 2), the complete graph, momentum 0.9 + ``gossip_every`` 2 +
``grad_accum`` 2, ``online_w`` with the dense W and with its
``ScheduleArrays``, and ``fsdp`` on the 8 rows at once; qwen3-0.6b's smoke
config (float32), per-node batch 2 x 32 tokens.

Tolerance (float32): losses within 1e-5 relative; every parameter leaf
within 1e-5 relative plus 1e-5 of the leaf's largest magnitude (entries
near zero have no relative scale). Port-only: the rollouts (``"scan"``
and ``"loop"``) equal three ``train_step`` calls; a swap in
``run_segments`` adds no capture; a resumed ``run_segments`` is bitwise
the uninterrupted one; every argument left for later items raises
``NotImplementedError``; ``impl="kernel"`` is refused.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as J_get_smoke  # noqa: E402
from repro.models import registry as J_registry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.mixing import BirkhoffSchedule, PoolSwap, ScheduleArrays  # noqa: E402
from repro_torch.obs import RetraceGuard, Tracer  # noqa: E402
from repro_torch.train import lm_trainer  # noqa: E402
from repro_torch.train.lm_trainer import make_train_setup  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NAME = "qwen3-0.6b"
N, B, S, STEPS, LR = 4, 2, 32, 3, 2e-2
RTOL = 1e-5
ARMS = {
    "schedule": dict(mode="dsgd", schedule=True),
    "complete": dict(mode="dsgd"),
    "momentum": dict(mode="dsgd", schedule=True, momentum=0.9, gossip_every=2, grad_accum=2),
    "online_dense": dict(mode="dsgd", online_w="dense"),
    "online_arrays": dict(mode="dsgd", online_w="arrays"),
    "fsdp": dict(mode="fsdp"),
}

_REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.compat import AxisType, make_compat_mesh, set_mesh
from repro.configs import get_smoke_config
from repro.core import learn_topology, schedule_from_result
from repro.core.mixing import schedule_to_arrays
from repro.train.lm_trainer import make_train_setup
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_config

out, arms = sys.argv[1], json.loads(sys.argv[2])
N, B, S, STEPS, LR = {N}, {B}, {S}, {STEPS}, {LR}
mesh = make_compat_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = get_smoke_config("{NAME}")
pcfg = port_config("{NAME}")
Pi = np.eye(2)[np.arange(N) % 2].astype(float)
sched = schedule_from_result(learn_topology(Pi, budget=2, lam=0.5))
arrays = schedule_to_arrays(sched)
W = np.asarray(sched.to_matrix(), np.float32)
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab_size, (STEPS, N, B, S)).astype(np.int32)
labels = rng.integers(0, cfg.vocab_size, (STEPS, N, B, S)).astype(np.int32)
res = {{"coeffs": np.asarray(sched.coeffs, np.float64),
        "perms": np.asarray(sched.perms, np.int32), "tokens": toks, "labels": labels}}
with set_mesh(mesh):
    for arm, kw in arms.items():
        kw = dict(kw)
        mode = kw.pop("mode")
        online = kw.pop("online_w", None)
        schedule = sched if kw.pop("schedule", False) else None
        setup = make_train_setup(cfg, mesh, mode=mode, schedule=schedule, lr=LR,
                                 online_w=online is not None, **kw)
        res[arm + "/comm_bytes"] = np.asarray(-1 if setup.comm_bytes_per_step is None
                                              else setup.comm_bytes_per_step)
        res[arm + "/transport"] = np.asarray(str(setup.sharded_transport))
        node = mode != "fsdp"
        params = jax.jit(setup.init_params)(jax.random.PRNGKey(0))
        if arm == "schedule":
            for k, v in convert.lm_stacked_from_numpy(
                    jax.tree_util.tree_map(np.asarray, params), pcfg, device="cpu").items():
                res["init/" + k] = v.numpy()
        opt = setup.init_opt_state(params)
        step = jax.jit(setup.train_step)
        losses = []
        for t in range(STEPS):
            if node:
                batch = {{"tokens": jnp.asarray(toks[t]), "labels": jnp.asarray(labels[t])}}
            else:
                batch = {{"tokens": jnp.asarray(toks[t].reshape(N * B, S)),
                          "labels": jnp.asarray(labels[t].reshape(N * B, S))}}
            extra = ()
            if online == "dense":
                extra = (jnp.asarray(W),)
            elif online == "arrays":
                extra = (arrays,)
            params, opt, loss = step(params, opt, batch, *extra)
            losses.append(float(loss))
        res[arm + "/losses"] = np.asarray(losses, np.float64)
        final = convert.lm_stacked_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg,
                                              node_axis=node, device="cpu")
        for k, v in final.items():
            res[arm + "/final/" + k] = v.numpy()
np.savez(out, **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json

    out = str(tmp_path_factory.mktemp("lm_trainer") / "reference.npz")
    code = textwrap.dedent(_REFERENCE.format(N=N, B=B, S=S, STEPS=STEPS, LR=LR, NAME=NAME))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code, out, json.dumps(ARMS)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _schedule(ref) -> BirkhoffSchedule:
    return BirkhoffSchedule(coeffs=tuple(float(c) for c in ref["coeffs"]),
                            perms=tuple(tuple(int(i) for i in p) for p in ref["perms"]))


def _init(ref, node: bool = True) -> dict:
    out = {k[len("init/"):]: torch.as_tensor(v) for k, v in ref.items() if k.startswith("init/")}
    return out if node else {k: v[0].clone() for k, v in out.items()}


def _batches(ref, node: bool = True) -> dict:
    toks, labels = ref["tokens"].astype(np.int64), ref["labels"].astype(np.int64)
    if not node:
        toks, labels = toks.reshape(STEPS, N * B, S), labels.reshape(STEPS, N * B, S)
    return {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}


def _operand(ref, kind):
    sched = _schedule(ref)
    if kind == "dense":
        return torch.as_tensor(sched.to_matrix(), dtype=torch.float32)
    if kind == "arrays":
        return ScheduleArrays(gammas=torch.as_tensor(sched.coeffs, dtype=torch.float32),
                              perms=torch.as_tensor(np.asarray(sched.perms), dtype=torch.int32))
    return None


def _port_setup(ref, arm: str, **extra):
    kw = dict(ARMS[arm])
    mode = kw.pop("mode")
    online = kw.pop("online_w", None)
    schedule = _schedule(ref) if kw.pop("schedule", False) else None
    setup = make_train_setup(get_smoke_config(NAME), n_nodes=N, mode=mode, schedule=schedule,
                             lr=LR, online_w=online is not None, device="cpu", **kw, **extra)
    return setup, _operand(ref, online), mode != "fsdp"


def _assert_params(port: dict, ref: dict, arm: str) -> None:
    for name, value in port.items():
        want = ref[f"{arm}/final/{name}"]
        np.testing.assert_allclose(value.numpy(), want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("arm", list(ARMS))
def test_three_steps_match_reference(reference, arm):
    setup, operand, node = _port_setup(reference, arm)
    params = _init(reference, node)
    opt = setup.init_opt_state(params)
    batches = _batches(reference, node)
    extra = (operand,) if operand is not None else ()
    losses = []
    for t in range(STEPS):
        params, opt, loss = setup.train_step(params, opt, {k: v[t] for k, v in batches.items()},
                                             *extra)
        assert loss.dtype == torch.float32 and loss.shape == ()
        losses.append(float(loss))
    np.testing.assert_allclose(losses, reference[f"{arm}/losses"], rtol=RTOL)
    _assert_params(params, reference, arm)
    # the modeled bytes a node receives a step and the resolved transport
    comm = setup.comm_bytes_per_step
    assert (-1 if comm is None else comm) == int(reference[f"{arm}/comm_bytes"])
    assert str(setup.sharded_transport) == str(reference[f"{arm}/transport"])
    if ARMS[arm].get("gossip_every", 1) > 1:
        assert int(opt["step"]) == STEPS


@pytest.mark.parametrize("rollout", ["scan", "loop"])
@pytest.mark.parametrize("arm", ["momentum", "online_arrays", "fsdp"])
def test_rollouts_match_reference_and_each_other(reference, arm, rollout):
    """The multi-step rollout over the same three steps: the reference's
    losses and parameters, and on the CPU bitwise the ``train_step`` loop."""
    setup, operand, node = _port_setup(reference, arm)
    params = _init(reference, node)
    opt = setup.init_opt_state(params)
    batches = _batches(reference, node)
    extra = (operand,) if operand is not None else ()
    multi = setup.multi_step_fn(rollout)
    p, o, losses = multi(params, opt, batches, *extra)
    np.testing.assert_allclose(losses.numpy(), reference[f"{arm}/losses"], rtol=RTOL)
    _assert_params(p, reference, arm)
    q, _, step_losses = params, opt, []
    for t in range(STEPS):
        q, _, loss = setup.train_step(q, _, {k: v[t] for k, v in batches.items()}, *extra)
        step_losses.append(loss)
    assert torch.equal(losses, torch.stack(step_losses))
    assert all(torch.equal(p[k], q[k]) for k in p)
    # the inputs are left as they were; a second call continues from its arguments
    assert torch.equal(params["embed.table"], _init(reference, node)["embed.table"])
    p2, _, losses2 = multi(params, opt, batches, *extra)
    assert torch.equal(losses2, losses) and all(torch.equal(p2[k], p[k]) for k in p)
    assert multi.n_traces == 1  # scan: captured at its 2nd run; loop: one body


def _run(setup, params, opt, batches, operand, **kw):
    return setup.run_segments(params, opt, batches, operand, segment_len=2, **kw)


def _long_batches(steps: int = 8) -> dict:
    rng = np.random.default_rng(1)
    cfg = get_smoke_config(NAME)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, N, B, S)))
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}


def test_run_segments_swap_adds_no_capture(reference):
    setup, operand, _ = _port_setup(reference, "online_arrays")
    params = _init(reference)
    batches = _long_batches()
    L = operand.l_max  # a swap of the same shape: cyclic shifts, equal weights
    dense = ScheduleArrays(gammas=torch.full((L,), 1.0 / L), perms=torch.as_tensor(
        [[(i + j) % N for i in range(N)] for j in range(L)], dtype=torch.int32))
    guard = RetraceGuard()
    tracer = Tracer()
    plain = _run(setup, params, None, batches, operand)
    swapped = _run(setup, params, None, batches, operand,
                   on_segment=lambda t: dense if t == 3 else None,
                   retrace_guard=guard, tracer=tracer)
    assert plain["n_traces"] == swapped["n_traces"] == 1  # captured at the 2nd segment
    assert guard.counts["run_segments.multi_step"] == 1
    assert swapped["swaps"] == [3] and plain["swaps"] == []
    assert np.array_equal(plain["losses"][:5], swapped["losses"][:5])
    assert not np.array_equal(plain["losses"][5:], swapped["losses"][5:])
    assert torch.equal(swapped["mix"].gammas, dense.gammas)
    assert len(tracer.spans("segment.rollout")) == 4
    assert swapped["losses"].shape == (8,) and swapped["recompiles"] == 0
    assert swapped["comm"]["steps"] == 8


@pytest.mark.parametrize("checkpoint_every", [1, 2])
def test_run_segments_resume_is_bitwise(reference, tmp_path, checkpoint_every):
    setup, operand, _ = _port_setup(reference, "online_dense", momentum=0.9, gossip_every=2)
    params = _init(reference)
    opt = setup.init_opt_state(params)
    batches = _long_batches()
    swap = torch.full((N, N), 1.0 / N)

    def hook(t):
        return swap if t == 1 else None

    whole = _run(setup, params, opt, batches, operand, on_segment=hook)
    ck = str(tmp_path / "ck")
    first = _run(setup, params, opt, batches, operand, on_segment=hook, checkpoint_dir=ck,
                 checkpoint_every=checkpoint_every, stop_after_segments=3)
    assert first["stopped_at"] == 6
    rest = _run(setup, params, opt, batches, operand, on_segment=hook, checkpoint_dir=ck,
                checkpoint_every=checkpoint_every, resume=True)
    assert rest["resumed_from"] == 6
    assert np.array_equal(np.concatenate([first["losses"], rest["losses"]]), whole["losses"])
    assert all(torch.equal(rest["params"][k], whole["params"][k]) for k in whole["params"])
    assert torch.equal(rest["opt_state"]["step"], whole["opt_state"]["step"])
    assert all(torch.equal(rest["opt_state"]["m"][k], whole["opt_state"]["m"][k])
               for k in whole["params"])
    assert torch.equal(rest["mix"], swap)  # the pre-crash swap survived


def test_bfloat16_checkpoint_resume_is_bitwise(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(NAME), dtype="bfloat16")
    setup = make_train_setup(cfg, n_nodes=N, lr=1e-2, online_w=True, device="cpu")
    params = setup.init_params(0)
    batches = _long_batches(4)
    w = torch.full((N, N), 1.0 / N)
    whole = _run(setup, params, None, batches, w)
    ck = str(tmp_path / "ck")
    _run(setup, params, None, batches, w, checkpoint_dir=ck, stop_after_segments=1)
    rest = _run(setup, params, None, batches, w, checkpoint_dir=ck, resume=True)
    assert rest["params"]["embed.table"].dtype == torch.bfloat16
    assert all(torch.equal(rest["params"][k], whole["params"][k]) for k in whole["params"])


@pytest.mark.parametrize("kw", [
    dict(mode="dsgd_pod"), dict(sharded_transport="pool", online_w=True),
    dict(pool=object(), online_w=True), dict(compression="bf16", online_w=True),
    dict(staleness=object(), online_w=True), dict(probes=object(), online_w=True),
], ids=["dsgd_pod", "sharded_pool", "pool", "compression", "staleness", "probes"])
def test_arguments_left_for_later_items_raise(kw):
    # dsgd_pod runs on a (pod, data, model) mesh (tests/test_torch_lm_mesh_modes.py):
    # stacked nodes have no pod axis; the stacked robustness options are item 13f
    err, match = (ValueError, "'pod' mesh axis") if kw.get("mode") == "dsgd_pod" else \
        (NotImplementedError, "item 13f")
    with pytest.raises(err, match=match):
        make_train_setup(get_smoke_config(NAME), n_nodes=N, device="cpu", **kw)


@pytest.mark.parametrize("what", ["delays", "quarantine", "pool_swap", "pool_gammas"])
def test_run_segments_arguments_left_for_later_items_raise(reference, what):
    setup, operand, _ = _port_setup(reference, "online_dense")
    params = _init(reference)
    batches = _long_batches(4)
    kw, mix = {}, operand
    if what in ("delays", "quarantine"):
        kw[what] = np.zeros((4, N), np.int64) if what == "delays" else object()
    elif what == "pool_swap":
        kw["on_segment"] = lambda t: PoolSwap(gammas=np.zeros(3, np.float32))
    else:
        mix = np.zeros(3, np.float32)
    with pytest.raises(NotImplementedError, match="item 13f"):
        _run(setup, params, None, batches, mix, **kw)


def test_impl_kernel_is_refused():
    with pytest.raises(ValueError, match="backward"):
        make_train_setup(get_smoke_config(NAME), n_nodes=N, impl="kernel", device="cpu")


def test_online_and_argument_checks(reference):
    cfg = get_smoke_config(NAME)
    with pytest.raises(ValueError, match="fsdp"):
        make_train_setup(cfg, mode="fsdp", online_w=True, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_setup(cfg, n_nodes=N, online_w=True, schedule=_schedule(reference),
                         device="cpu")
    setup, operand, _ = _port_setup(reference, "schedule")
    params = _init(reference)
    batch = {k: v[0] for k, v in _batches(reference).items()}
    with pytest.raises(TypeError, match="online_w"):
        setup.train_step(params, None, batch, operand if operand is not None else
                         torch.eye(N))
    with pytest.raises(ValueError, match="online_w"):
        setup.run_segments(params, None, _long_batches(4), torch.eye(N), segment_len=2)
    ge = make_train_setup(cfg, n_nodes=N, gossip_every=2, device="cpu")
    with pytest.raises(ValueError, match="step counter"):
        ge.train_step(params, None, batch)


def test_stacked_params_round_trip_the_reference_layout():
    """``lm_stacked_to_numpy`` inverts ``lm_stacked_from_numpy`` on the
    reference's node-stacked pytree (qwen3 and recurrentgemma's groups
    and tail, whisper's flat layer lists), bitwise."""
    for name, n in (("qwen3-0.6b", 4), ("recurrentgemma-2b", 2), ("whisper-small", 2)):
        jcfg, pcfg = J_get_smoke(name), get_smoke_config(name)
        single = J_registry.init_model(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree_util.tree_map(
            lambda x: np.asarray(jnp.broadcast_to(x[None], (n,) + x.shape)), single)
        stacked = convert.lm_stacked_from_numpy(tree, pcfg, device="cpu")
        assert all(v.shape[0] == n and not v.requires_grad for v in stacked.values())
        back = convert.lm_stacked_to_numpy(stacked, pcfg)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [jax.tree_util.keystr(p) for p, _ in flat_a] == \
            [jax.tree_util.keystr(p) for p, _ in flat_b]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))


def test_grad_fn_gives_every_nodes_loss(reference):
    setup, _, _ = _port_setup(reference, "complete")
    params = _init(reference)
    batch = {k: v[0] for k, v in _batches(reference).items()}
    losses, grads = setup.grad_fn(params, batch)
    assert losses.shape == (N,) and set(grads) == set(params)
    assert all(g.shape == params[k].shape for k, g in grads.items())
    # equal replicas on different batches: different losses, one mean
    _, _, loss = setup.train_step(params, None, batch)
    assert torch.allclose(losses.mean(), loss)
    assert lm_trainer.gossip_fn(None, N)(grads)["embed.table"].shape == params["embed.table"].shape


def test_training_forward_recomputes_blocks_bitwise(monkeypatch):
    """With ``remat=True`` the training forward recomputes each layer and
    each loss chunk in the backward pass (the reference's remat): the
    losses and gradients are bitwise those of the default forward, which
    keeps its activations and recomputes nothing."""
    from repro_torch.models import transformer

    cfg = get_smoke_config(NAME)
    setup = make_train_setup(cfg, n_nodes=2, lr=1e-2, device="cpu", remat=True)
    params = setup.init_params(0)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 2, 1024)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}  # 2 loss chunks
    calls = []
    remat = transformer._remat
    monkeypatch.setattr(transformer, "_remat", lambda fn, *a: calls.append(fn) or remat(fn, *a))
    losses, grads = setup.grad_fn(params, batch)
    assert len(calls) == 2 * (cfg.num_layers + 2)  # each node: every layer, both chunks
    calls.clear()
    kept_losses, kept = make_train_setup(cfg, n_nodes=2, lr=1e-2, device="cpu").grad_fn(
        params, batch)
    assert not calls
    assert torch.equal(losses, kept_losses)
    assert all(torch.equal(grads[k], kept[k]) for k in grads)
