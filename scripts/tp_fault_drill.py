#!/usr/bin/env python3
"""Plant a fault in ``chip_smoke.py`` phase 14's tensor-parallel arms and
show that the phase's checks catch it, at the published widths.

    python3 scripts/tp_fault_drill.py [--faults latent_per_rank,gates_cut_per_rank]

Each fault belongs to the family whose split it breaks:

  latent_per_rank      deepseek-v2-236b (1 layer, mesh (1, 4)): MLA's
                       latent, split by the rules, normalised on each
                       rank's block (its own sum of squares) and then
                       gathered, where ``kv_norm`` is an RMS norm over all
                       r latents;
  gates_cut_per_rank   recurrentgemma-2b (3 layers, mesh (1, 4)): the
                       RG-LRU's gates read only this rank's features of the
                       recurrent branch (the other ranks' blocks zero).

For each family the one-card yardstick (``chip_smoke.tp_yardstick``) runs
in this process, then four rank processes (NCCL over its socket transport,
as in phase 14) run the arm (``chip_smoke.tp_arm``) clean and then with
the fault planted in ``repro_torch.models.parallel`` (whose functions the
model blocks call). One JSON line a
family: each rank's gaps to the yardstick (``chip_smoke.tp_errors``) for
the clean and the faulty run, the limits, and whether phase 14's checks
(``chip_smoke.check_tp``) passed. The card's name and power limit come
before the last line. Exits 0 when every clean run passes and every
planted fault fails the checks. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

FAMILY = {"latent_per_rank": "deepseek-v2-236b", "gates_cut_per_rank": "recurrentgemma-2b"}


def _latent_per_rank(c_local, norm, eps, tp, split):
    """MLA's split latent normalised on each rank's block, then gathered."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.train import tensor_parallel as T

    if not split:
        return rms_norm(types.SimpleNamespace(scale=T.copy_to(norm.scale, tp)), c_local, eps)
    c = rms_norm(types.SimpleNamespace(scale=T.slice_last(norm.scale, tp)), c_local, eps)
    return T.gather_last_partial(c, tp)


def _branch_cut(x_local, tp):
    """The recurrent branch the gates read cut to this rank's features."""
    from repro_torch.train import tensor_parallel as T

    full = T.gather_last_partial(x_local, tp)
    w = x_local.shape[-1]
    keep = torch.zeros(full.shape[-1], dtype=full.dtype, device=full.device)
    keep[tp.rank * w:(tp.rank + 1) * w] = 1
    return full * keep


PLANTS = {"latent_per_rank": ("latent_norm", _latent_per_rank),
          "gates_cut_per_rank": ("branch", _branch_cut)}


def drill(rank: int, n: int, init: str, yard: dict, device: torch.device) -> dict:
    """On one rank: each fault's family clean, then with the fault."""
    import torch.distributed as dist

    from repro_torch.models import parallel

    device = C.join_ranks(rank, n, init, device)
    out = {}
    for fault in yard["faults"]:
        name = FAMILY[fault]
        attr, planted = PLANTS[fault]
        for run in ("clean", "faulty"):
            arms: dict = {}

            def measured(label, k, fn):
                res = fn()
                arms[label] = {"steps": k}
                return res

            original = getattr(parallel, attr)
            if run == "faulty":
                setattr(parallel, attr, planted)
            try:
                C.tp_arm(name, device, measured, arms)
            finally:
                setattr(parallel, attr, original)
            arm = arms[f"tp_{name}"]
            out[f"{fault}/{run}"] = {k: arm[k] for k in ("losses", "loss32", "grad", "coords")}
            C.free_card()
    dist.barrier()
    dist.destroy_process_group()
    return out


def _worker(rank: int, n: int, init: str, yard: dict, device: torch.device, queue) -> None:
    os.environ.update(C.rank_env(rank))
    try:
        queue.put((rank, drill(rank, n, init, yard, device), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def run(faults: list[str], device: torch.device, worker=_worker) -> bool:
    """The drill (module docstring); True when every check went as it
    should."""
    yard = {"faults": faults}
    for fault in faults:
        yard[FAMILY[fault]] = C.tp_yardstick(FAMILY[fault], device)
        C.free_card()
    rows, wall = C.spawn_ranks(worker, C.RANKS["nodes"], {"faults": faults}, device,
                               C.MESH["timeout_s"], "tp fault drill")
    ok = True
    for fault in faults:
        name = FAMILY[fault]
        line = {"fault": fault, "family": name, "mesh": list(C.TP_FAMILIES[name][1]),
                "limits": {"loss": C.TP_LOSS_TOL, "loss32": C.TP_LOSS32_TOL,
                           "grad_rtol": C.TP_GRAD_RTOL},
                "yardstick_losses": yard[name]["mean"], "ranks_wall_s": wall}
        for run_ in ("clean", "faulty"):
            errs, passed = [], []
            for r, row in enumerate(rows):
                arm = row[f"{fault}/{run_}"]
                err = C.tp_errors(arm, yard[name], arm["coords"])
                errs.append(err | {"losses": arm["losses"]})
                try:
                    C.check_tp(f"{fault} {run_} rank {r}", arm, yard[name], err)
                    passed.append(True)
                except RuntimeError:
                    passed.append(False)
            line[run_] = {"errors": errs, "checks_pass": passed}
        line["caught"] = not any(line["faulty"]["checks_pass"])
        ok = ok and all(line["clean"]["checks_pass"]) and line["caught"]
        C.note("# tp fault drill " + json.dumps(line))
    return ok


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--faults", default=",".join(PLANTS),
                        help=f"comma-separated, of {sorted(PLANTS)}")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tp_fault_drill: needs a CUDA card", file=sys.stderr)
        return 1
    faults = [f for f in args.faults.split(",") if f]
    unknown = [f for f in faults if f not in PLANTS]
    if unknown:
        parser.error(f"unknown faults {unknown}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C._build.build_all()
    ok = run(faults, torch.device("cuda"))
    print(C.card())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
