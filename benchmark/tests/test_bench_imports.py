"""No module a run loads has the top-level name jax, jaxlib, flax or
adapm_tpu; the reference imports nothing of the port; a run without its
cards, or without the program beside the benchmark, prints no result."""
import ast
import glob
import json
import os
import shutil
import subprocess
import sys

from benchmark import common

ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _py(code: str, cwd: str = common.ROOT, timeout: int = 300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_a_run_loads_no_jax():
    code = ("import sys, json\n"
            "from benchmark.tests.toy import run_toy, CELLS\n"
            "for c in CELLS: run_toy(c, trace=True)\n"
            "from benchmark.common import forbidden_modules\n"
            "print(json.dumps(forbidden_modules()))\n")
    p = _py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "adapm_tpu_torch_x", sys)
    assert "adapm_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "adapm_tpu.core", sys)
    assert "adapm_tpu" in common.forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(common.HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                assert n.split(".")[0] not in ("adapm_tpu_torch",
                                               "adapm_tpu", "jax"), path
    p = _py("import sys, benchmark.reference.complex, benchmark.reference.rank;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr
    loaded = p.stdout
    assert "adapm_tpu_torch" not in loaded and "'jax'" not in loaded


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "complex_wd5m.eval_b64", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=common.ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "complex_wd5m.eval_b64", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
