"""Cells, configurations, traffic mixes, limits, problem families,
references and metric readers, found by name from ``BENCHMARK.json``.

  * a cell is an entry of ``workloads``; its configuration's file is the
    one ``configs`` names, its traffic mix is ``traffic/<traffic>.json``
    and its limits are ``limits/<cell>.json``, all under ``cardbench/``;
  * a configuration's ``family`` is drawn by ``harness/families/
    <family>.py`` (``make(config, traffic, seed)``), and a mix's
    ``solver`` is answered by ``reference/solvers/<solver>.py``
    (``answers(config, traffic, problems, seeds, device, tf32)``);
  * a metric is read by ``metrics/<name>.py``, or where that file does
    not exist by ``metrics/<stem>.py``, ``<stem>`` the name before its
    first dot (``api_overhead_ms.sb`` -> ``api_overhead_ms.py``); the
    file defines ``read(ctx)``, which returns a number or None.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (by default ``BENCHMARK.json``) with
    its files read."""
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no cell {name!r}; cells: {sorted(work)}")
    w = work[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "cardbench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root / config["file"]),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def module(path: Path, kind: str):
    """The Python file ``path`` as a module, named ``cardbench_<kind>_
    <stem>``; KeyError where it does not exist."""
    if not path.exists():
        raise KeyError(f"no {kind} {path.stem!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str, root: Path = ROOT):
    """The problem family ``name``'s generator: its ``make(config,
    traffic, seed)``."""
    return module(root / "cardbench" / "harness" / "families"
                  / f"{name}.py", "family")


def reference(solver: str, root: Path = ROOT):
    """The plain reference of the solver ``solver``: its ``answers(config,
    traffic, problems, seeds, device, tf32)``."""
    return module(root / "cardbench" / "reference" / "solvers"
                  / f"{solver}.py", "reference")


def reader(metric: str, root: Path = ROOT):
    """Metric ``metric``'s reader file as a module: its ``read(ctx)``,
    and where it has one, ``info(ctx)``, a dict printed beside the
    metric."""
    here = root / "cardbench" / "metrics"
    path = here / f"{metric}.py"
    if not path.exists():
        path = here / f"{metric.split('.')[0]}.py"
    return module(path, "metric")
