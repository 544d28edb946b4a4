"""``repro_torch.launch`` against the reference's ``repro/launch/`` and
``models.common.active_param_count``.

* ``active_param_count``, ``roofline.param_counts`` and
  ``roofline.analytic_flops`` equal the reference's for all ten full
  configs and the four input shapes (the port's counts from meta models).
* The dry run (``launch/dryrun.py``): a smoke config's decode step on a
  fake 4-rank ``(2, 2)`` group reports the collective bytes by kind and
  the argument bytes that the same step's counters give on 4 real gloo
  ranks (``_torch_ranks.serve_mesh_job``), on two arms: deepseek-v2's MLA
  (latents gathered) on (2, 2) in the long-context mode, qwen3-0.6b on
  (1, 4) (its cache split by head_dim: the scores' partial products
  reduced); one full-width combo, qwen3-0.6b x decode_32k on 16x16 (256
  fake ranks), runs on meta.
* ``roofline_row`` keeps the reference's row keys; ``axis_bandwidth``
  puts an axis on NVLink only where its group fits in one 8-GPU node.
* ``build_topology`` equals the reference's for its four kinds.
* The CLI (``python -m repro_torch.launch.train``) runs 3 steps on the
  CPU, as one process and on a (2, 2) mesh under ``torchrun``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
B, S, STEPS, MAX_LEN = 2, 8, 1, 16
DRY_ARMS = {
    "deepseek_2x2_long": dict(cfg="deepseek-v2-236b", mesh=(2, 2), long=True,
                              over={"long_context_window": 8}),
    "qwen3_1x4": dict(cfg="qwen3-0.6b", mesh=(1, 4)),
}


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _python(code: str, timeout: float = 300) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                          text=True, timeout=timeout, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


# ---------------------------------------------------------------------------
# Parameter counts and model FLOPs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_roofline():
    from repro.launch import roofline as J_roofline

    return J_roofline


def test_active_param_count_equals_the_reference(reference_roofline):
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import get_config
    from repro_torch.models import active_param_count, transformer, whisper
    from repro_torch.launch import roofline

    for arch in J_ARCH_IDS:
        cfg = get_config(arch)
        meta = whisper.Whisper(cfg, "meta") if cfg.arch_type == "audio" else \
            transformer.LM(cfg, "meta")
        total, active = reference_roofline.param_counts(arch)
        assert active_param_count(meta, cfg) == active, arch
        shapes = {k: tuple(p.shape) for k, p in meta.named_parameters()}
        assert active_param_count(shapes, cfg) == active, arch
        assert roofline.param_counts(arch) == (total, active), arch
        if cfg.moe is not None:
            assert active < total, arch


def test_analytic_flops_and_bytes_equal_the_reference(reference_roofline):
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import INPUT_SHAPES as J_SHAPES
    from repro_torch.launch import roofline

    rec = {"mode": "dsgd", "memory": {"argument_bytes": 3 * 2**30}}
    for arch in J_ARCH_IDS:
        for shape in J_SHAPES:
            assert roofline.analytic_flops(arch, shape) == \
                reference_roofline.analytic_flops(arch, shape), (arch, shape)
            assert roofline.analytic_bytes_per_device(arch, shape, rec, 256) == \
                reference_roofline.analytic_bytes_per_device(arch, shape, rec, 256)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

_DRY = """
import dataclasses, json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
arms = json.loads(sys.argv[1])
out = {{}}
for name, arm in arms.items():
    shape = {{"seq_len": {max_len}, "global_batch": {batch},
             "kind": "decode_long" if arm.get("long") else "decode"}}
    mesh = "x".join(map(str, arm["mesh"]))
    cfg = dataclasses.replace(get_smoke_config(arm["cfg"]), **arm.get("over", {{}}))
    out[name] = [dryrun.run_one(arm["cfg"], "decode", mesh, None, rank=r, shape=shape, cfg=cfg)
                 for r in (0, 3)]
print("RECORDS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def dry_and_gloo(tmp_path_factory):
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_DRY.format(max_len=MAX_LEN, batch=B)),
         json.dumps(DRY_ARMS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT)
    try:
        gloo = _torch_ranks.spawn_ranks(4, _torch_ranks.serve_mesh_job,
                                        tmp_path_factory.mktemp("dry_gloo"), DRY_ARMS, B, S,
                                        STEPS, MAX_LEN)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    line = next(x for x in stdout.splitlines() if x.startswith("RECORDS "))
    return json.loads(line[len("RECORDS "):]), gloo


@pytest.mark.parametrize("arm", list(DRY_ARMS))
def test_dry_run_bytes_equal_the_gloo_counters(dry_and_gloo, arm):
    records, gloo = dry_and_gloo
    for rec in records[arm]:
        assert rec["status"] == "ok", rec.get("traceback")
        row = next(g for g in gloo if g["_rank"] == rec["rank"])[arm]
        assert rec["coords"] == row["coords"]
        kinds = {k: v for k, v in rec["collectives"].items()
                 if k not in ("calls", "by_axis", "total_bytes")}
        assert kinds == row["step_bytes"], (arm, kinds, row["step_bytes"])
        assert rec["memory"]["argument_bytes"] == row["argument_bytes"]
        assert rec["collectives"]["total_bytes"] == sum(row["step_bytes"].values())
        assert set(rec["collectives"]["by_axis"]) == {"model"}
        assert rec["cost"]["flops_per_device"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert any(k.startswith("tp_") for k in gloo[0][arm]["step_bytes"])


def test_full_width_decode_runs_on_meta(tmp_path):
    """qwen3-0.6b x decode_32k on the 16x16 mesh: 256 fake ranks, rank 17
    (data 1, model 1)."""
    out = _python(f"""
        from repro_torch.launch import dryrun
        rec = dryrun.run_one("qwen3-0.6b", "decode_32k", "16x16", {str(tmp_path)!r}, rank=17)
        import json
        print("RECORD " + json.dumps(rec))
    """, timeout=600)
    rec = json.loads(next(x for x in out.splitlines() if x.startswith("RECORD "))[7:])
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["coords"] == {"data": 1, "model": 1}
    assert (tmp_path / "qwen3-0.6b__decode_32k__16x16.json").exists()
    # a rank holds a 16th of the weights (bf16), its 8 requests' cache split by head_dim
    assert 0.5e9 < rec["memory"]["argument_bytes"] < 3e9
    assert rec["cost"]["flops_per_device"] > 2 * 0.6e9 * 8 / 16
    assert rec["collectives"]["tp_all_reduce"] > 0 and rec["collectives"]["tp_all_gather"] > 0
    assert set(rec["collectives"]["by_axis"]) == {"model"}

    from repro_torch.launch import roofline

    row = roofline.roofline_row(rec)
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["collective_s"] == rec["collectives"]["total_bytes"] / 50e9


def test_roofline_row_keeps_the_reference_structure(reference_roofline):
    from repro_torch.launch import roofline

    mem = {"argument_bytes": 2**30, "output_bytes": 0, "temp_bytes": 2**29}
    ref_rec = {"arch": "qwen3-0.6b", "shape": "decode_32k", "mesh": "16x16", "status": "ok",
               "mode": "serve_decode", "memory": mem,
               "cost": {"flops_per_device_hlo": 1e12}, "collectives": {"total_bytes": 2**20},
               "scan_trip": 28}
    port_rec = {**ref_rec, "cost": {"flops_per_device": 1e12},
                "collectives": {"total_bytes": 2**20, "by_axis": {"model": 2**20}},
                "scan_trip": 1}
    want = reference_roofline.roofline_row(ref_rec)
    got = roofline.roofline_row(port_rec)
    assert list(got) == list(want)
    assert got["model_flops"] == want["model_flops"]
    assert got["compute_s"] == want["model_flops"] / (256 * 989e12)
    assert roofline.roofline_row({"status": "error"}) is None


@pytest.mark.parametrize("mesh,axis,bw", [("16x16", "model", 50e9), ("16x16", "data", 50e9),
                                          ("2x16x16", "pod", 50e9), ("2x2", "model", 450e9),
                                          ("2x2", "data", 450e9), ("1x4", "model", 450e9)])
def test_axis_bandwidth(mesh, axis, bw):
    from repro_torch.launch import roofline

    assert roofline.axis_bandwidth(mesh, axis) == bw


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["stl-fw", "random", "ring", "complete"])
def test_build_topology_equals_the_reference(kind):
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.train import build_topology as J_build_topology
    finally:  # the reference's training script sets XLA_FLAGS at import
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from repro_torch.launch.train import build_topology

    n, n_domains = 6, 4
    Pi = np.full((n, n_domains), 0.1 / (n_domains - 1))
    Pi[np.arange(n), np.arange(n) % n_domains] = 0.9
    Pi /= Pi.sum(1, keepdims=True)
    want = J_build_topology(kind, Pi, 2, 0.1)
    got = build_topology(kind, Pi, 2, 0.1, device="cpu")
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(got.to_matrix(), np.asarray(want.to_matrix()), atol=1e-9)
    assert got.n_communication_atoms == want.n_communication_atoms


def test_cli_draws_the_batchers_batches():
    """The CLI draws a step's node batches in threads: the same arrays as
    ``TokenBatcher.next_batch``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.data.tokens import DomainSkewCorpus, TokenBatcher
    from repro_torch.launch.train import next_batch

    corpus = DomainSkewCorpus(vocab_size=512, n_domains=4, seed=0)
    Pi = np.full((3, 4), 0.25)
    batcher = TokenBatcher(corpus, Pi, 2, 16, seed=1)
    with ThreadPoolExecutor(3) as pool:
        for step in (0, 5):
            got, want = next_batch(batcher, step, pool), batcher.next_batch(step)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_cli_trains_three_steps_on_the_cpu(tmp_path):
    out = _python(f"""
        from repro_torch.launch.train import main
        main(["--steps", "3", "--device", "cpu", "--seq-len", "32", "--data", "2",
              "--ckpt-dir", {str(tmp_path)!r}])
    """)
    line = next(x for x in out.splitlines() if x.startswith("loss: "))
    first, last = (float(v) for v in line.split()[1:4:2])
    assert np.isfinite(first) and np.isfinite(last)
    assert "step    0" in out and "step    2" in out
    assert (tmp_path / "step_00000003" / "manifest.json").exists()


def test_cli_trains_on_a_mesh_under_torchrun(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
           "--rdzv-backend", "c10d", "--rdzv-endpoint", "localhost:0", "-m",
           "repro_torch.launch.train", "--steps", "3", "--device", "cpu", "--seq-len", "16",
           "--data", "2", "--model", "2"]
    env = _env()
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [x for x in proc.stdout.splitlines() if x.startswith("loss: ")]
    assert len(lines) == 1  # the first rank prints
    assert all(np.isfinite(float(v)) for v in lines[0].split()[1:4:2])
