"""Shared helpers of the benchmark's CPU tests: the repository's paths,
the cells kept for later (``later/<cell>.json``, their entries as they
would join ``BENCHMARK.json``) and the cells at sizes a test run holds."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from cardbench.harness import spec  # noqa: E402

#: per cell: traffic and configuration keys changed for the CPU; the
#: control's anneal judges more runs, as its differences are rarer
TINY = {
    "chip64-anneal": ({"problems": 2, "runs": 256, "check_calls": 2}, {}),
    "g22-sb": ({"runs": 64, "check_calls": 2},
               {"n": 200, "degree": 5.0}),
}
LISTS = ("configs", "workloads", "end_to_end", "per_layer")
LATER = {f.stem: json.loads(f.read_text())
         for f in sorted((ROOT / "cardbench" / "tests" / "later")
                         .glob("*.json"))}


def bench() -> dict:
    """``BENCHMARK.json`` with the entries of the cells kept for later."""
    out = spec.load_benchmark()
    for more in LATER.values():
        out = {k: out[k] + more[k] if k in LISTS else out[k] for k in out}
    return out


def cell(name: str) -> spec.Cell:
    """A cell of ``BENCHMARK.json`` or one kept for later."""
    return spec.cell(name, bench())


CONTROL = {"chip64-anneal": {"problems": 2, "runs": 1024}}
SB_STEPS = 150


def tiny_cell(name: str, control: bool = False) -> spec.Cell:
    """The committed cell, limits included, cut to a CPU test's size."""
    c = cell(name)
    traffic, config = TINY[name]
    c.traffic.update(traffic)
    if control:
        c.traffic.update(CONTROL.get(name, {}))
    c.config.update(config)
    if c.traffic["solver"] == "sb-jax":
        c.traffic["solver_opts"] = dict(c.traffic["solver_opts"],
                                        n_steps=SB_STEPS)
    return c
