"""The benchmark's files on their own: what they import, BENCHMARK.json's
form, and that a configuration, a traffic mix and a per-layer metric are
found by name once their files and entries are added."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import bench
from perfbench.counts import gossip, linear, qwen3

PB = bench.ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
# what a plain reference may import, by top-level name
REFERENCE_IMPORTS = {"__future__", "numpy", "scipy", "torch", "perfbench"}


def _imports(path: Path) -> set[str]:
    """Every module ``path`` imports, by its dotted name (relative imports
    anchored at the perfbench package)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("perfbench" if node.level else (node.module or ""))
    return out


def _sources() -> list[Path]:
    return sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(bench.FORBIDDEN_MODULES), (path, tops & set(bench.FORBIDDEN_MODULES))
    if "reference" in path.relative_to(PB).parts:
        names = _imports(path)
        assert {n.split(".")[0] for n in names} <= REFERENCE_IMPORTS, (path, names)
        assert all(n == "perfbench" or n.startswith("perfbench.reference")
                   for n in names if n.split(".")[0] == "perfbench"), (path, names)


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("repro_torch_like"))
    assert bench.forbidden_modules() == [m for m in bench.forbidden_modules()
                                         if m.split(".")[0] in bench.FORBIDDEN_MODULES]
    assert "repro_torch_like" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert "jaxlib.fake" in bench.forbidden_modules()


def _check(bm: dict, root: Path) -> None:
    """BENCHMARK.json against the benchmark's contract."""
    assert set(bm) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    assert 1 <= len(bm["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
                                                 and not p.startswith("/") and ".." not in p
                                                 for p in bm["paths"])
    assert 1 <= len(bm["command"]) <= 32 and all(LINE.match(w) for w in bm["command"])
    assert isinstance(bm["run_seconds"], int) and 1 <= bm["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (bm["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in bm["configs"]}
    assert len(configs) == len(bm["configs"]) and 1 <= len(configs) <= 24
    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("perfbench/") and (root / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert (root / "perfbench" / "drivers"
                / f"{bench.load_json(root / c['file'])['driver']}.py").is_file()
    cells = {w["name"]: w for w in bm["workloads"]}
    assert len(cells) == len(bm["workloads"]) and 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in bm["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in bm["workloads"]) <= max(1, len(cells) // 4)
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (root / "perfbench" / "traffic" / f"{w['name']}.json").is_file()
    assert {w["config"] for w in bm["workloads"]} == set(configs)
    metrics = bm["end_to_end"] + bm["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert 1 <= len(bm["end_to_end"]) <= 16 and 1 <= len(bm["per_layer"]) <= 128
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in metrics:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if m in bm["end_to_end"] else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys, m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(w in cells for w in m.get("workloads", []))
    for m in bm["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bm["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert bench.module_path("layer_metrics", m["name"], root).is_file()
        # every cell that reads this metric reports the metric it moves
        for w in m.get("workloads", list(cells)):
            assert w in e2e[m["moves"]].get("workloads", list(cells)), (m["name"], w)
    for w in cells:
        reported = [m["name"] for m in bench.cell_metrics(bm, w, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2, w
        assert bench.cell_metrics(bm, w, "per_layer"), w


def test_benchmark_json_keeps_the_contract():
    _check(bench.benchmark(), bench.ROOT)
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_files_dropped_into_the_folder_are_found_by_name(tmp_path):
    """A later PR adds a cell, a configuration and a per-layer metric by
    adding files and entries alone."""
    shutil.copytree(PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bm = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    cfg = bench.load_json(PB / "configs" / "mnist-linear-dsgd.json")
    (tmp_path / "perfbench" / "configs" / "mnist-linear-b128.json").write_text(
        json.dumps(dict(cfg, name="mnist-linear-b128", batch_size=128)))
    traffic = bench.load_json(PB / "traffic" / "sim.mnist-linear.n100-d10.json")
    (tmp_path / "perfbench" / "traffic" / "sim.mnist-linear-b128.n64-d8.json").write_text(
        json.dumps(dict(traffic, n_nodes=64, budget=8)))
    (tmp_path / "perfbench" / "layer_metrics" / "calls.sim.py").write_text(
        "def read(out, ctx):\n    return out.attempted\n")
    bm["configs"].append({"name": "mnist-linear-b128",
                          "source": "https://arxiv.org/abs/2204.04452",
                          "file": "perfbench/configs/mnist-linear-b128.json", "reduced": [],
                          "why": "minibatches of 128"})
    bm["workloads"].append({"name": "sim.mnist-linear-b128.n64-d8", "config": "mnist-linear-b128",
                            "traffic": "sim.mnist-linear-b128.n64-d8", "chips": 1,
                            "why": "n 64, budget 8"})
    bm["end_to_end"][0]["workloads"].append("sim.mnist-linear-b128.n64-d8")
    bm["per_layer"].append({"name": "calls.sim", "unit": "count", "better": "higher",
                            "source": "program_counter", "layer": "entry point, sim",
                            "moves": "sim_steps_per_s",
                            "workloads": ["sim.mnist-linear-b128.n64-d8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    got = bench.benchmark(tmp_path)
    _check(got, tmp_path)
    w, config, traffic_found = bench.cell(got, "sim.mnist-linear-b128.n64-d8", tmp_path)
    assert config["batch_size"] == 128 and traffic_found["n_nodes"] == 64
    assert bench.load_module("drivers", config["driver"], tmp_path).run
    names = [m["name"] for m in bench.cell_metrics(got, w["name"], "per_layer")]
    assert "calls.sim" in names
    reader = bench.load_module("layer_metrics", "calls.sim", tmp_path)
    out = bench.Outcome(attempted=7, failed=0, end_to_end={}, layer={}, checks=[],
                        memory_peak_bytes=0, window_start=0.0)
    assert reader.read(out, None) == 7
    # and the cells already there are untouched
    cell = "sim.mnist-linear.n100-d10"
    assert [m["name"] for m in bench.cell_metrics(got, cell, "per_layer")] \
        == [m["name"] for m in bench.cell_metrics(bench.benchmark(), cell, "per_layer")]


def test_a_metric_of_a_family_falls_back_to_the_familys_reader(tmp_path):
    """``idle_share.sim`` and ``idle_share.train`` share ``idle_share.py``;
    a file of the metric's own name comes first."""
    (tmp_path / "perfbench" / "layer_metrics").mkdir(parents=True)
    (tmp_path / "perfbench" / "layer_metrics" / "share.py").write_text(
        "def read(out, ctx):\n    return 1\n")
    (tmp_path / "perfbench" / "layer_metrics" / "share.own.py").write_text(
        "def read(out, ctx):\n    return 2\n")
    assert bench.load_module("layer_metrics", "share.any", tmp_path).read(None, None) == 1
    assert bench.load_module("layer_metrics", "share.own", tmp_path).read(None, None) == 2
    with pytest.raises(FileNotFoundError):
        bench.module_path("layer_metrics", "other.any", tmp_path)


@pytest.mark.parametrize("what,got,worked", [
    # 4 P B n, P = 784 * 10 + 10 = 7,850, batch 64, n 100
    ("linear step at n 100", lambda: linear.train_flops_per_step(100, 64, 784, 10), 200.96e6),
    # N = 28 (1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024 + 3 * 1024 * 3072)
    #     + 1024 * 151,936 = 595,984,384; 6 N + 12 * 28 * 16 * 128 * 1024
    ("qwen3-0.6b token at S 1,024",
     lambda: qwen3.train_flops_per_token(bench.load_json(PB / "configs" / "qwen3-0.6b-dsgd.json"),
                                         1024), 4.28055e9),
    # 2 * 100 * 7,850 * 4 bytes and 2 * 1,000 * 7,850 FLOPs
    ("mix bytes at n 100", lambda: gossip.mix_bytes(100, 7850, 4, 0), 6.28e6),
    ("mix FLOPs at nnz 1,000", lambda: gossip.mix_flops(1000, 7850), 15.7e6),
])
def test_counts_match_hand_worked_values(what, got, worked):
    assert got() == pytest.approx(worked, rel=1e-4), what


def test_a_reader_with_nothing_to_read_returns_nothing():
    out = bench.Outcome(attempted=1, failed=0, end_to_end={}, layer={}, checks=[],
                        memory_peak_bytes=0, window_start=0.0)
    for m in bench.benchmark()["per_layer"]:
        assert bench.load_module("layer_metrics", m["name"]).read(out, None) is None, m["name"]


def test_trace_arithmetic():
    trace = bench.Trace(device=[("gossip_mix", 10, 20), ("gemm", 15, 30), ("gemm", 50, 60),
                                ("outside", 200, 300)],
                        host=[("bench.call", 0, 100), ("aten::copy_", 35, 45)],
                        window=(0, 100))
    assert trace.window_s == 100e-9
    assert trace.busy_s() == pytest.approx(30e-9)
    assert trace.op_s(("gossip_",)) == pytest.approx(10e-9)
    assert trace.top_ops()[0] == ["gemm", pytest.approx(25e-9)]
    gaps = trace.idle_gaps()
    assert gaps[0] == ["bench.call/host", pytest.approx(40e-9)]
    assert ["bench.call/aten::copy_", pytest.approx(20e-9)] in gaps


def test_emit_puts_the_checks_last(capsys):
    bench.emit({"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}},
               [("loss_gap", 0.5, 1.0)])
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["checks"]["loss_gap"] == {"value": 0.5,
                                                                         "limit": 1.0}
    assert captured.err.strip().splitlines()[-1] == "check loss_gap = 0.5 (limit 1.0)"
