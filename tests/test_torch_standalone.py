"""The port stands alone: no JAX and nothing of the reference package.

``repro_torch`` and ``chip_smoke.py`` run on a machine without JAX, so
importing them must load neither ``jax`` nor ``repro``. The numpy host
modules the port copied from the reference must stay verbatim copies
(``obs/trace.py``: the parts it kept).
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.core.mixing import ScheduleArrays  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORTS_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke  # its helpers; main() runs only as a script
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print("LEAKED", leaked)
print("COUNT", sum(m.startswith("repro_torch") for m in sys.modules))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = _IMPORTS_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    assert lines["LEAKED"] == "[]"
    assert int(lines["COUNT"]) >= 20  # every module of the package was imported


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b)", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + [
        "chip_smoke.py",
        # what the rank processes of the tests and of the probe import
        "tests/_torch_ranks.py", "scripts/rank_backend_probe.py"],
)
def test_sources_import_no_jax_and_no_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)


@pytest.mark.parametrize(
    "module",
    ["data/synthetic.py", "data/partition.py", "core/topology.py",
     "core/heterogeneity.py", "core/dcliques.py", "core/theory.py", "core/dynamic.py",
     "data/drift.py", "online/streaming.py", "obs/trace.py", "obs/report.py",
     "data/tokens.py"],
)
def test_host_copies_stay_verbatim(module):
    reference = ROOT / "src" / "repro" / module
    if module in _PARTIAL_COPIES:
        port, ref = _defs(PORT / module), _defs(reference)
        for name in _PARTIAL_COPIES[module]:
            assert port[name] == ref[name], name
        return
    assert (PORT / module).read_bytes() == reference.read_bytes()


# modules that began as copies and changed: what they kept stays verbatim
# (obs/trace.py opens profiler ranges and has no exporters)
_PARTIAL_COPIES = {
    "obs/trace.py": ("SpanRecord.duration_s", "Tracer._stack", "Tracer._now",
                     "Tracer.instant", "Tracer.spans", "Tracer.total_s", "Tracer.summary"),
}


def _defs(path: Path) -> dict[str, str]:
    """Each method's source, by ``Class.method``."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out[f"{node.name}.{item.name}"] = ast.get_source_segment(text, item)
    return out


@pytest.mark.parametrize("module", ["faults/plan.py", "faults/quarantine.py"])
def test_fault_copies_differ_only_in_their_imports(module):
    """The numpy fault modules are copies whose imports point at the port:
    with ``repro_torch.`` read as ``repro.`` they are the reference's."""
    port = (PORT / module).read_text().replace("from repro_torch.", "from repro.")
    assert port == (ROOT / "src" / "repro" / module).read_text()
    assert "from repro_torch." in (PORT / module).read_text()


_IMPORTS_ONE = r"""
import importlib, sys
sys.path.insert(0, {src!r})
importlib.import_module({module!r})
print("LEAKED", sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                       or m == "repro" or m.startswith("repro.")))
"""


@pytest.mark.parametrize("module", ["repro_torch.train.sharding",
                                    "repro_torch.train.tensor_parallel",
                                    "repro_torch.train.mesh_layout",
                                    "repro_torch.serve.engine",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.roofline",
                                    "repro_torch.launch.train"])
def test_mesh_modules_alone_load_no_jax(module):
    code = _IMPORTS_ONE.format(src=str(ROOT / "src"), module=module)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "LEAKED []"


def test_mesh_rank_processes_load_no_jax(tmp_path):
    """Two gloo ranks build a (1, 2) mesh and take a tensor-parallel step:
    neither loads jax."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_ranks

    rows = _torch_ranks.spawn_ranks(2, _torch_ranks.mesh_import_job, tmp_path)
    assert all(not r["_jax_loaded"] for r in rows)
    assert rows[0]["loss"] == rows[1]["loss"] and np.isfinite(rows[0]["loss"])
    assert "repro_torch.train.tensor_parallel" in rows[0]["modules"]


def test_launch_entry_points_run_without_jax(tmp_path):
    """``launch/``'s dry run (qwen3-0.6b's decode step on the fake 16x16
    group) and its roofline over that record run in a process without
    the tests' ``PYTHONPATH``, and load neither jax nor the reference."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT / "src")!r})
from repro_torch.launch import dryrun, roofline
rec = dryrun.run_one("qwen3-0.6b", "decode_32k", "16x16", {str(tmp_path)!r})
roofline.main(["--dryrun", {str(tmp_path)!r}, "--out", {str(tmp_path / "r.md")!r}])
print("STATUS", rec["status"])
print("LEAKED", sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                       or m == "repro" or m.startswith("repro.")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("STATUS", "LEAKED")))
    assert lines == {"STATUS": "ok", "LEAKED": "[]"}
    assert "| qwen3-0.6b | decode_32k | 16x16 |" in (tmp_path / "r.md").read_text()
    assert (tmp_path / "r.json").exists()


def test_convert_round_trips():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(3, np.float32)}
    back = convert.params_to_numpy(convert.params_from_numpy(tree, "cpu"))
    assert all(np.array_equal(back[k], v) and back[k].dtype == v.dtype for k, v in tree.items())
    sa = convert.schedule_arrays_from_numpy([0.5, 0.5], [[0, 1, 2], [2, 0, 1]], "cpu")
    assert isinstance(sa, ScheduleArrays) and sa.perms.dtype == torch.int32
    assert sa.l_max == 2 and sa.n_nodes == 3
    with pytest.raises(ValueError):
        convert.schedule_arrays_from_numpy([1.0], [[0, 0, 1]], "cpu")


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
