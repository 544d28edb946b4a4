"""The hand-written CUDA gossip kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.mixing import (  # noqa: E402
    mix_stacked,
    schedule_from_result,
    schedule_to_arrays,
)
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.kernels.gossip_mix import ops, ref  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    ops.reset_launch_counts()
    return torch.device("cuda")


def _schedule(n: int):
    labels = np.random.default_rng(n).integers(0, 10, size=30 * n)
    Pi = dirichlet_partition(labels, n, alpha=0.3, seed=0)[1]
    return schedule_from_result(learn_topology(Pi, budget=min(4, n), lam=0.1))


def _theta(n, P, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, P), generator=gen).to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# gossip_mix's kernels: float32 n <= 128 the 3xTF32 one (n = 9, 128),
# n = 129 and 161 (float32) W resident in shared memory, n = 512 K-tiled;
# bfloat16 W-resident up to n = 192. n = 9, 129 and 161 are not
# multiples of 8; P = 4113, 1001, 4099, 515 and 2051 are odd and P = 50890
# is 2 mod 4: no 16-byte copies.
@pytest.mark.parametrize("n,P", [(2, 1), (33, 4113), (100, 50896), (7, 300), (9, 1001),
                                 (128, 333), (129, 515), (161, 4099), (512, 2051),
                                 (100, 50890)])
def test_kernels_match_plain_on_card(cuda, n, P, dtype):
    sched = _schedule(n)
    t = _theta(n, P, dtype, cuda)
    g, p = sched.operands(cuda)
    out = ops.gossip_schedule(t, g, p)
    # the same float32 arithmetic in the same order: bitwise equal
    torch.testing.assert_close(out, ref.gossip_schedule_ref(t, g, p), atol=0, rtol=0)
    W = torch.as_tensor(sched.to_matrix(), dtype=torch.float32, device=cuda)
    mixed = ops.gossip_mix(t, W)
    tol = TOL[dtype]
    torch.testing.assert_close(mixed.float(), ref.gossip_mix_ref(t, W.to(dtype)).float(),
                               atol=tol, rtol=tol)
    assert ops.launch_counts == {"gossip_schedule": 1, "gossip_mix": 1}


def _atoms(n: int, L: int, zeros: int, seed: int, device):
    """The identity and L - 1 random permutations with positive weights,
    then ``zeros`` zero-weight padding atoms (as ``ScheduleArrays`` pads)."""
    rng = np.random.default_rng(seed)
    perms = [np.arange(n)] + [rng.permutation(n) for _ in range(L - 1 + zeros)]
    g = rng.random(L) + 0.1
    g = np.concatenate([g / g.sum(), np.zeros(zeros)])
    return (torch.as_tensor(g, dtype=torch.float32, device=device),
            torch.as_tensor(np.stack(perms), dtype=torch.int32, device=device))


# The staged kernel (float32; bfloat16 runs the l2 gather) keeps a column
# tile of all n rows in shared memory; on an H100 (227 KB a block) n = 100
# takes 512-byte rows, n = 500 with
# L = 3 128-byte rows, n = 1000 two 64-byte stages, n = 1500 one, and with
# L = 2 n = 2075 is the last n that holds one (its perms table, 8 atoms a
# row, takes the rest): n = 2076 runs the l2 gather.
# P = 4099 and 777 are odd; offset 1 puts every row off the 16-byte grid.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,P,L,zeros,offset,design", [
    (100, 50896, 11, 0, 0, "staged tile, 512-byte rows x 4 stages"),
    (100, 50890, 11, 3, 0, "staged tile"),
    (100, 4096, 11, 0, 1, "staged tile"),
    (7, 4099, 3, 2, 1, "staged tile, 512-byte rows x 8 stages"),
    (500, 3001, 3, 0, 1, "staged tile, 128-byte rows x 3 stages"),
    (1000, 520, 3, 0, 0, "staged tile, 64-byte rows x 2 stages"),
    (1500, 777, 3, 0, 1, "staged tile, 64-byte rows x 1 stages"),
    (2075, 300, 2, 0, 0, "staged tile, 64-byte rows x 1 stages"),
    (2076, 300, 2, 0, 0, "l2 gather"),
    (4096, 1001, 3, 1, 1, "l2 gather"),
])
def test_gossip_schedule_designs_match_plain_on_card(cuda, n, P, L, zeros, offset, design, dtype):
    g, p = _atoms(n, L, zeros, n + P, cuda)
    buf = _theta(1, n * P + offset, dtype, cuda, 4)[0]
    t = buf[offset:].view(n, P)
    assert t.is_contiguous() and (t.data_ptr() % 16 != 0) == (offset != 0)
    want = design if dtype == torch.float32 else "l2 gather"
    assert ops.gossip_schedule_design(n, L + zeros, dtype).startswith(want)
    out = ops.gossip_schedule(t, g, p)
    # the same float32 arithmetic in the same order: bitwise equal
    torch.testing.assert_close(out, ref.gossip_schedule_ref(t, g, p), atol=0, rtol=0)
    assert ops.launch_counts == {"gossip_schedule": 1, "gossip_mix": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,P", [(100, 4096), (9, 1000), (512, 1028)])
def test_gossip_mix_on_misaligned_theta(cuda, n, P, dtype):
    """A contiguous theta at offset 1 of a larger buffer: its rows start
    4 (float32) or 2 (bfloat16) bytes off the 16-byte grid."""
    W = torch.as_tensor(_schedule(n).to_matrix(), dtype=torch.float32, device=cuda)
    buf = _theta(1, n * P + 1, dtype, cuda, 3)[0]
    t = buf[1:].view(n, P)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    mixed = ops.gossip_mix(t, W)
    tol = TOL[dtype]
    torch.testing.assert_close(mixed.float(), ref.gossip_mix_ref(t, W.to(dtype)).float(),
                               atol=tol, rtol=tol)
    assert ops.launch_counts["gossip_mix"] == 1


@pytest.mark.cuda
def test_mixing_on_card_goes_through_the_kernels(cuda):
    n = 33
    sched = _schedule(n)
    tree = {"w": _theta(n, 120, torch.float32, cuda, 1).reshape(n, 12, 10),
            "b": _theta(n, 10, torch.float32, cuda, 2)}
    W = torch.as_tensor(sched.to_matrix(), dtype=torch.float32, device=cuda)
    for use_kernel in (False, True):
        dense = mix_stacked(tree, W=W, transport="dense", use_kernel=use_kernel)
        sparse = mix_stacked(tree, schedule=sched, transport="schedule", use_kernel=use_kernel)
        arrays = mix_stacked(tree, schedule=schedule_to_arrays(sched, l_max=sched.n_atoms + 2,
                                                                device=cuda))
        for k in tree:
            torch.testing.assert_close(dense[k], sparse[k], atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(arrays[k], sparse[k], atol=0, rtol=0)
    # per use_kernel: one gossip_mix per leaf, one gossip_schedule per schedule mix
    assert ops.launch_counts == {"gossip_schedule": 4, "gossip_mix": 4}


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    t = _theta(4, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        ops.gossip_schedule(t, torch.ones(1), torch.arange(4, dtype=torch.int32)[None].to(cuda))
