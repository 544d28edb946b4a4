"""The LM trainer on the card: its mixing kernels against their plain
versions inside a step, and the captured rollout bitwise the eager one.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no JAX (``tests/test_torch_lm_trainer.py`` holds the port
against the reference on the CPU), so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_train_cuda.py

* one step's parameters are the kernel mix of its half-step, bitwise,
  through ``gossip_schedule`` (a schedule, a ``ScheduleArrays``) and
  ``gossip_mix`` (a dense W, the complete graph); that half-step plus
  N(0, 0.02) noise per node (the nodes of one shared init differ by
  little), mixed by the kernel, against the plain version of the same
  mix on the CPU: elementwise within one rounding of the result (2^-7
  relative in bfloat16, 2^-20 in float32) plus 1e-6, where the unmixed
  input misses by more than 10 times that;
* ``multi_step_fn("scan")`` (captured bodies) bitwise ``"loop"`` (the
  same bodies, eager) over 6 steps with momentum, ``gossip_every`` 2 and
  ``grad_accum`` 2, one capture, mixing launches on the on-steps only;
* ``run_segments`` with a swap at a boundary adds no capture.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.mixing import BirkhoffSchedule, ScheduleArrays  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as gossip_ops  # noqa: E402
from repro_torch.train.lm_trainer import _sgd_update, gossip_fn, make_train_setup  # noqa: E402

N, B, S = 4, 2, 64
# both mixes sum in float32 and round once to the leaf dtype: one rounding
# of the result, relative, plus 1e-6 where a sum cancels
REL = {"float32": 2.0 ** -20, "bfloat16": 2.0 ** -7}
ABS = 1e-6
NOISE = 0.02  # per node on the held half-step: about a weight's size
# a ring and its reverse: a 3-atom schedule on 4 nodes
SCHEDULE = BirkhoffSchedule(coeffs=(0.5, 0.25, 0.25),
                            perms=((0, 1, 2, 3), (1, 2, 3, 0), (3, 0, 1, 2)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path is checked only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gossip_ops.reset_launch_counts()
    return torch.device("cuda")


def _cfg(dtype: str):
    return dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype=dtype)


def _batches(cfg, steps: int, device, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (steps, N, B, S), generator=g)
    return {"tokens": toks.to(device), "labels": torch.roll(toks, -1, -1).to(device)}


def _excess(out: dict, plain: dict, dtype: str) -> float:
    """max |out - plain| / (REL |plain| + ABS) over every leaf (on the
    CPU): at most 1 holds."""
    return max((((out[k].float().cpu() - plain[k].float()).abs()
                 / (REL[dtype] * plain[k].float().abs() + ABS)).max().item()) for k in out)


def _arrays(device) -> ScheduleArrays:
    return ScheduleArrays(gammas=torch.tensor(SCHEDULE.coeffs, device=device),
                          perms=torch.tensor(SCHEDULE.perms, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["schedule", "complete", "dense", "arrays"])
def test_step_mix_kernel_matches_plain(cuda, dtype, kind):
    cfg = _cfg(dtype)
    online = kind in ("dense", "arrays")
    setup = make_train_setup(cfg, n_nodes=N, lr=1e-2, device=cuda, online_w=online,
                             schedule=SCHEDULE if kind == "schedule" else None)
    params = setup.init_params(0)
    batch = {k: v[0] for k, v in _batches(cfg, 1, cuda).items()}
    operand = {"dense": torch.tensor(SCHEDULE.to_matrix(), dtype=torch.float32, device=cuda),
               "arrays": _arrays(cuda)}.get(kind)
    extra = (operand,) if online else ()
    kernel = "gossip_mix" if kind in ("complete", "dense") else "gossip_schedule"
    _, grads = setup.grad_fn(params, batch)
    half, _ = _sgd_update(params, grads, None, 1e-2, 0.0)
    gossip_ops.reset_launch_counts()
    after, _, loss = setup.train_step(params, None, batch, *extra)
    assert gossip_ops.launch_counts[kernel] >= 1 and torch.isfinite(loss)
    if kind == "schedule":
        mix = gossip_fn(SCHEDULE, N)
        plain_mix = gossip_fn(SCHEDULE, N, use_kernel=True)
    elif kind == "complete":
        mix, plain_mix = gossip_fn(None, N), gossip_fn(None, N, use_kernel=True)
    else:
        from repro_torch.core.mixing import mix_dense, mix_schedule_arrays

        if kind == "dense":
            mix = lambda p: mix_dense(p, operand)  # noqa: E731
            plain_mix = lambda p: mix_dense(p, operand.cpu(), use_kernel=True)  # noqa: E731
        else:
            mix = lambda p: mix_schedule_arrays(p, operand)  # noqa: E731
            cpu = ScheduleArrays(operand.gammas.cpu(), operand.perms.cpu())
            plain_mix = lambda p: mix_schedule_arrays(p, cpu, use_kernel=True)  # noqa: E731
    mixed = mix(half)
    for name in params:
        assert torch.equal(after[name], mixed[name]), name  # the step is the kernel mix
    g = torch.Generator(device=cuda).manual_seed(1)
    noisy = {k: v + NOISE * torch.randn(v.shape, generator=g, device=cuda, dtype=v.dtype)
             for k, v in half.items()}
    mixed = mix(noisy)
    plain = plain_mix({k: v.cpu() for k, v in noisy.items()})
    assert _excess(mixed, plain, dtype) <= 1.0
    assert _excess(noisy, plain, dtype) > 10.0  # a mix that returned its input would fail


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_is_bitwise_loop(cuda, dtype):
    cfg = _cfg(dtype)
    setup = make_train_setup(cfg, n_nodes=N, lr=1e-2, momentum=0.9, gossip_every=2,
                             grad_accum=2, schedule=SCHEDULE, device=cuda)
    params = setup.init_params(0)
    opt = setup.init_opt_state(params)
    batches = _batches(cfg, 6, cuda)
    scan, loop = setup.multi_step_fn("scan"), setup.multi_step_fn("loop")
    outs = {}
    for name, fn in (("scan", scan), ("loop", loop)):
        p, o = params, opt
        losses = []
        gossip_ops.reset_launch_counts()
        for seg in range(3):  # 3 calls of 2 steps: warm-up, capture, replay
            p, o, lo = fn(p, o, {k: v[2 * seg:2 * seg + 2] for k, v in batches.items()})
            losses.append(lo)
        torch.cuda.synchronize()
        outs[name] = (p, o, torch.cat(losses), dict(gossip_ops.launch_counts))
    (ps, os_, ls, cs), (pl, ol, ll, cl) = outs["scan"], outs["loop"]
    assert torch.equal(ls, ll)
    assert all(torch.equal(ps[k], pl[k]) for k in ps)
    assert all(torch.equal(os_["m"][k], ol["m"][k]) for k in ps)
    assert int(os_["step"]) == int(ol["step"]) == 6
    assert scan.n_traces == 1 and loop.n_traces == 1
    assert cs["gossip_schedule"] == cl["gossip_schedule"] == 3  # the on-steps
    assert torch.isfinite(ls).all()


@pytest.mark.cuda
def test_run_segments_swap_adds_no_capture(cuda):
    cfg = _cfg("bfloat16")
    setup = make_train_setup(cfg, n_nodes=N, lr=1e-2, online_w=True, device=cuda)
    params = setup.init_params(0)
    batches = _batches(cfg, 8, cuda)
    other = ScheduleArrays(gammas=torch.tensor([0.25, 0.5, 0.25], device=cuda),
                           perms=_arrays(cuda).perms)
    out = setup.run_segments(params, None, batches, _arrays(cuda), segment_len=2,
                             on_segment=lambda t: other if t == 3 else None)
    assert out["n_traces"] == 1 and out["swaps"] == [3]
    assert torch.equal(out["mix"].gammas, other.gammas)
