"""The ranks driver (``drivers/lm_train_ranks.py``) on the CPU: qwen3's smoke
widths, four nodes on four gloo ranks (this test's child process is rank
0 and starts the other three), held to the stacked reference with the LM
cell's limits; and one rank training on labels moved one token on fails
them.

Each run is a child process with a time limit of its own (a rank that
hangs fails the test instead of holding the suite).
"""

from __future__ import annotations

import json
import subprocess
import sys

from perfbench import bench

LIMIT_S = 55
SCRIPT = r"""
import argparse, json, sys
import torch
torch.set_num_threads(1)
from perfbench import bench, run
from perfbench.tests.test_perfbench_lm import WORKLOAD, _small
cfg, tr = _small()
cfg = dict(cfg, driver="lm_train_ranks")
if sys.argv[1] == "rank0_alter":
    from perfbench.drivers import lm_train
    orig = lm_train._slice
    def moved(pool, start, k):
        out = orig(pool, start, k)
        return dict(out, labels=out["labels"].roll(1, dims=-1))
    lm_train._slice = moved
args = argparse.Namespace(workload=WORKLOAD, seed=2**31 + 21, seconds=0.2, trace=1)
line, checks = run.measure(args, torch.device("cpu"), config=cfg, traffic=tr)
print(json.dumps({"line": line, "checks": checks}))
"""


def _run(mode: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", SCRIPT, mode], cwd=bench.ROOT, text=True,
                          capture_output=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_four_gloo_ranks_match_the_stacked_reference():
    out = _run("sound")
    line = out["line"]
    assert line["correct"], out["checks"]
    assert all(value <= limit / 10 for _, value, limit in out["checks"]), out["checks"]
    assert line["metrics"]["captures.train"]["value"] == 1
    assert "mfu.train" in line["metrics"]


def test_one_rank_on_altered_labels_is_not_correct():
    assert not _run("rank0_alter")["line"]["correct"]
