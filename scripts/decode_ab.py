#!/usr/bin/env python3
"""Host cost of the eager decode step of two checkouts, on one NVIDIA GPU.

    python3 scripts/decode_ab.py OLD_SRC

Times the eager greedy loop -- ``serve.engine.prefill``, then one
``serve.engine.decode_step`` per new token, as both checkouts define them
-- of ``repro_torch`` from this checkout's ``src/`` and from OLD_SRC (the
``src/`` of another checkout, e.g. one unpacked with ``git archive`` into
a gitignored directory), on recurrentgemma-2b at its published widths
(random bf16 weights from seed 0) at phase 4's shape: B = 2, a 2560-token
prompt, 32 new tokens. Each timing runs in a child process of its own
(two versions of one package cannot share a process), old, new, new, old;
a child prints the median over 3 runs of the loop less a prefill, over its
31 decode steps, and the loop's greedy tokens, which must agree. Then one
more child per checkout profiles a loop's host side (``torch.profiler``,
CPU activity only) and the script prints, per decode step, the operators
whose calls or self CPU time differ most between the two.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.serve import engine

cfg = get_config("recurrentgemma-2b")
model = registry.init_model(cfg, seed=0, device="cuda")
prompt = registry.make_inputs(cfg, 2, 2560, seed=1, device="cuda")["tokens"]
new = 32
max_len = 2560 + new + 1


def prefill():
    return engine.prefill(model, cfg, prompt, max_len=max_len)


def loop():
    logits, cache = prefill()
    toks = [logits.argmax(-1, keepdim=True)]
    for pos in range(2560, 2560 + new - 1):
        position = torch.full((2, 1), pos, device="cuda")
        logits, cache = engine.decode_step(model, cfg, toks[-1], position, cache)
        toks.append(logits.argmax(-1, keepdim=True))
    return torch.cat(toks, dim=1)


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


with torch.inference_mode():
    loop()  # warm-up
    if len(sys.argv) > 2:  # profile the host side of one loop
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            loop()
        ops = {e.key: [e.count / (new - 1), e.self_cpu_time_total / (new - 1)]
               for e in prof.key_averages()}
        print(json.dumps({"ops": ops}))
        sys.exit(0)
    pre = float(np.median([wall(prefill)[0] for _ in range(3)]))
    runs = [wall(loop) for _ in range(3)]
    total = float(np.median([t for t, _ in runs]))
print(json.dumps({"eager_decode_ms_per_token": 1e3 * (total - pre) / (new - 1),
                  "prefill_s": pre, "tokens": runs[0][1].tolist()}))
"""


def child(src: Path, *flags: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(src), *flags], capture_output=True,
                         text=True, check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = Path(sys.argv[1]).resolve(), ROOT / "src"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    results = []
    for label, src in (("old", old), ("new", new), ("new", new), ("old", old)):
        t0 = time.perf_counter()
        r = child(src)
        results.append(r)
        print(json.dumps({"arm": label, "src": str(src),
                          "eager_decode_ms_per_token": r["eager_decode_ms_per_token"],
                          "prefill_s": r["prefill_s"], "child_s": time.perf_counter() - t0}),
              flush=True)
    if any(r["tokens"] != results[0]["tokens"] for r in results):
        raise RuntimeError("the two checkouts' eager loops gave different greedy tokens")
    # per decode step (the loop's prefill included, spread over its steps):
    # [calls, self CPU us] of each operator, old and new
    before, after = child(old, "profile")["ops"], child(new, "profile")["ops"]
    diff = {k: [after.get(k, [0, 0])[i] - before.get(k, [0, 0])[i] for i in (0, 1)]
            for k in set(before) | set(after)}
    total = [sum(v[i] for v in after.values()) - sum(v[i] for v in before.values())
             for i in (0, 1)]
    print(json.dumps({"per_step_calls_diff": total[0], "per_step_self_cpu_us_diff": total[1]}))
    for name, (calls, us) in sorted(diff.items(), key=lambda kv: -abs(kv[1][1]))[:15]:
        print(json.dumps({"op": name, "calls_diff": calls, "self_cpu_us_diff": us,
                          "old": before.get(name), "new": after.get(name)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
