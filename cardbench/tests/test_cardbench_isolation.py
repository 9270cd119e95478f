"""The benchmark stands apart: what ``run.py`` loads holds neither JAX nor
the JAX package, the reference imports none of JAX, the JAX package or
the port, nothing under ``cardbench/`` reads the JAX package's benchmark
files, and ``run.py`` refuses to run without a card."""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import types

from cardbench_util import ROOT
from cardbench.harness import loop

HERE = ROOT / "cardbench"
#: the JAX package's benchmark files and folders
OLD = ("benchmarks" + "/", "BENCH" + "_", "experiments/" + "bench")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    return env


def test_what_run_loads_holds_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "sys.path[:0] = [%r, %r]\n"
        "sys.argv = ['run.py']\n"
        "import runpy; runpy.run_path(%r)\n"
        "from cardbench.harness import loop, spec\n"
        "import cardbench.reference.answers\n"
        "import repro_torch.api, repro_torch.core, repro_torch.solvers\n"
        "import repro_torch.kernels.ising_anneal, repro_torch.kernels.sb_kernel\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    c = spec.cell(w['name'])\n"
        "    [spec.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "    spec.family(c.config['family']).make(c.config, c.traffic, 1)\n"
        "    spec.reference(c.traffic['solver'])\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
        % (str(ROOT), str(ROOT / "src"), str(HERE / "run.py")))
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    m = types.ModuleType("m")
    monkeypatch.setattr(loop.sys, "modules", {
        "repro_torch": m, "repro_torch.api": m, "jaxtyping": m, "numpy": m})
    assert loop.forbidden_modules() == []
    monkeypatch.setattr(loop.sys, "modules", {
        "repro.core": m, "jax.numpy": m, "flax": m, "repro_torch": m})
    assert loop.forbidden_modules() == ["flax", "jax", "repro"]


def test_reference_imports_none_of_jax_repro_or_the_port():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro|repro_torch)"
                     r"\b", re.MULTILINE)
    files = sorted((HERE / "reference").rglob("*.py"))
    assert len(files) >= 5
    for f in files:
        assert not bad.search(f.read_text()), f


def test_no_file_of_the_benchmark_reads_the_jax_packages_benchmarks():
    files = [f for f in HERE.rglob("*") if f.is_file()
             and f.suffix in (".py", ".json")
             and f.parent.name != "tests"]
    assert files
    for f in files:
        text = f.read_text()
        for old in OLD:
            assert old not in text, (f, old)


def test_run_exits_nonzero_without_a_card():
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "g22-sb", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "g22-sb",
         "--seed", "5", "--seconds", "1", "--trace", "1"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
