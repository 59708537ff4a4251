"""No module of the harness or the reference has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``video_enhancer_tpu`` (compared whole:
``video_enhancer_tpu_torch`` is the port), and the reference imports
nothing of the port; a whole run loads none of them."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import BENCH, run_cell

JAX = {"jax", "jaxlib", "flax", "video_enhancer_tpu"}
PORT = "video_enhancer_tpu_torch"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


def test_sources_import_no_jax_and_the_reference_no_port():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & JAX, path
    for path in (BENCH / "reference").glob("*.py"):
        assert PORT not in _imports(path), path


def test_reference_alone_loads_no_port():
    code = (f"import sys, json\nsys.path[:0] = [{str(BENCH)!r}, "
            f"{str(BENCH / 'reference')!r}]\n"
            "from vebench import manifest\n"
            "for name in ('vsrm-x4', 'ditvr-restore'):\n"
            "    manifest.reference(name)\n"
            "print(json.dumps(sorted({m.partition('.')[0] for m in "
            "sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & (JAX | {PORT})


def test_a_run_loads_no_jax(tiny_root):
    """A whole run passes its own look for JAX in ``sys.modules``, which
    fails a run that has JAX loaded."""
    out = run_cell(tiny_root, "ditvr-restore.batch-720p")
    assert out["correct"] is True
    proc = run_cell(tiny_root, "ditvr-restore.batch-720p", rc=4,
                    prelude="import sys, types\n"
                            "sys.modules['jax'] = types.ModuleType('jax')")
    assert proc.stdout.strip() == ""
    assert "['jax']" in proc.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    import shutil

    from conftest import ROOT

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = run_cell(tmp_path, "vsrm-x4.batch-270p", rc=1)
    assert proc.stdout.strip() == ""
