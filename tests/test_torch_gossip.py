"""The port's gossip kernel wrappers against the reference's.

On the CPU the port's ``ops.gossip_schedule`` / ``ops.gossip_mix`` run
their plain versions; they are held against the reference's ``ops``
functions as the reference's own tests run them (Pallas interpret mode
from P = 2048 up, its jnp oracle below) and against its ``ref``
functions, at the reference's tolerances: 1e-5 for float32 and 3e-2 for
bfloat16 (``tests/test_kernels.py``). The CUDA kernels themselves are
held against the plain versions on the card in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.gossip_mix import ops as J_ops  # noqa: E402
from repro.kernels.gossip_mix import ref as J_ref  # noqa: E402
from repro_torch.core.mixing import schedule_from_result, schedule_to_arrays  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.kernels.gossip_mix import ops, ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _stl_schedule(n: int):
    """A real STL-FW schedule (atom 0 is the identity) for n nodes."""
    labels = np.random.default_rng(n).integers(0, 10, size=30 * n)
    Pi = dirichlet_partition(labels, n, alpha=0.3, seed=0)[1]
    res = learn_topology(Pi, budget=min(4, n), lam=0.1)
    return res, schedule_from_result(res)


def _theta(n: int, P: int, dtype: str, seed: int = 0):
    """The same inputs for both packages: numpy, rounded to ``dtype`` once."""
    x = np.random.default_rng(seed).normal(size=(n, P)).astype(np.float32)
    t = torch.from_numpy(x).to(TORCH_DTYPE[dtype])
    return t, jnp.asarray(t.float().numpy(), JAX_DTYPE[dtype])


def _close(port: torch.Tensor, ref_out, dtype: str) -> None:
    tol = TOL[dtype]
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts == {"gossip_schedule": 0, "gossip_mix": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1, 3000, 4096, 4113])
@pytest.mark.parametrize("n", [2, 8, 33])
def test_gossip_schedule_matches_reference(n, P, dtype):
    _, sched = _stl_schedule(n)
    assert sched.perms[0] == tuple(range(n))  # the identity atom rides along
    coeffs, perms = sched.coeff_array(), sched.perm_array()
    t, j = _theta(n, P, dtype, seed=n + P)
    out = ops.gossip_schedule(t, coeffs, perms)
    assert out.dtype == t.dtype and out.shape == t.shape
    _close(out, J_ops.gossip_schedule(j, coeffs, perms), dtype)
    _close(out, J_ref.gossip_schedule_ref(j, jnp.asarray(coeffs), jnp.asarray(perms)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1, 3000, 4096, 4113])
@pytest.mark.parametrize("n", [2, 8, 33])
def test_gossip_mix_matches_reference(n, P, dtype):
    res, _ = _stl_schedule(n)
    W = res.W.astype(np.float32)
    t, j = _theta(n, P, dtype, seed=2 * n + P)
    out = ops.gossip_mix(t, W)
    assert out.dtype == t.dtype and out.shape == t.shape
    # the wrapper casts W to theta's dtype first, as the reference's ops.py:55
    _close(out, J_ref.gossip_mix_ref(j, jnp.asarray(W).astype(JAX_DTYPE[dtype])), dtype)
    _close(out, J_ops.gossip_mix(j, jnp.asarray(W)), dtype)


def test_gossip_mix_quantizes_w_to_bf16():
    n, P = 8, 64
    t, _ = _theta(n, P, "bfloat16")
    W = np.full((n, n), 1.0 / 3.0, np.float32)  # 1/3 is inexact in bfloat16
    W_bf16 = torch.from_numpy(W).to(torch.bfloat16)
    assert torch.equal(ops.gossip_mix(t, W), ref.gossip_mix_ref(t, W_bf16))
    assert not torch.equal(ops.gossip_mix(t, W), ref.gossip_mix_ref(t, torch.from_numpy(W)))


@pytest.mark.parametrize("n", [8, 33])
def test_gossip_schedule_padded_arrays(n):
    _, sched = _stl_schedule(n)
    arrays = schedule_to_arrays(sched, l_max=sched.n_atoms + 3, device="cpu")
    assert float(arrays.gammas[-1]) == 0.0
    t, j = _theta(n, 1000, "float32", seed=7)
    padded = ops.gossip_schedule(t, arrays.gammas, arrays.perms)
    assert torch.equal(padded, ops.gossip_schedule(t, sched.coeff_array(), sched.perm_array()))
    _close(padded, J_ops.gossip_schedule(j, arrays.gammas.numpy(), arrays.perms.numpy()),
           "float32")


def test_gossip_apply_dispatch():
    res, sched = _stl_schedule(33)
    t, _ = _theta(33, 300, "float32")
    dense = ops.gossip_apply(t, W=res.W.astype(np.float32))
    via_schedule = ops.gossip_apply(t, schedule=sched)
    np.testing.assert_allclose(dense.numpy(), via_schedule.numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        ops.gossip_apply(t)


def test_wrappers_reject_what_the_kernels_do_not_take():
    t = torch.zeros((4, 10))
    eye = np.eye(4, dtype=np.float32)
    ident = np.arange(4, dtype=np.int32)[None]
    with pytest.raises(TypeError):
        ops.gossip_mix(t.double(), eye)
    with pytest.raises(ValueError):
        ops.gossip_mix(t.t(), np.eye(10))  # not contiguous
    with pytest.raises(ValueError):
        ops.gossip_mix(t, np.eye(3))
    with pytest.raises(ValueError):
        ops.gossip_schedule(t, [1.0], np.array([[0, 1, 2, 4]]))  # out of range
    with pytest.raises(ValueError):
        ops.gossip_schedule(t, [0.5, 0.5], ident)  # coeffs/perms mismatch
    with pytest.raises(ValueError):
        ops.gossip_schedule(t[0], [1.0], ident)  # not 2-D
