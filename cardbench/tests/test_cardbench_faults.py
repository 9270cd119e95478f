"""A run with the timed path broken underneath comes out as not correct;
a sound run comes out correct. Each drives the harness's run
(``loop.measure``) on the CPU at a test's size, past its look for a
card, with the committed limits.

The faults, planted where the program produces its answers: a step that
returns its state unchanged; half of the runs left out, their answers
taken from the rest; an answer altered (spin 0 of every run of problem 0
of the anneal, the first ten spins of one SB restart); and the best
run's spins altered after the energies were taken. (The cells run on
one card, so no exchange between cards can be left out.)
"""
from __future__ import annotations

import dataclasses
import json
import io
import time

import pytest
import torch

from cardbench_util import tiny_cell
from cardbench.harness import loop
import repro_torch.api as api
import repro_torch.core.engine as engine
import repro_torch.solvers.sb_jax as sb_jax
from repro_torch.core.annealer import AnnealResult
from repro_torch.core.hamiltonian import ising_energy

SEED = 2**31 + 21
CELLS = ["chip64-anneal", "g22-sb"]


def _measure(cell, seconds=0.2):
    return loop.measure(cell, SEED, seconds, False, "cpu",
                        time.perf_counter(), err=io.StringIO())


def _anneal_fault(fault):
    orig = engine.anneal

    def broken(J, v0, dev, pert, **kw):
        if fault == "unchanged":
            return orig(J, v0, dataclasses.replace(dev, anneal_sweeps=0.0),
                        pert, **kw)
        if fault == "half":
            h = v0.shape[1] // 2
            r = orig(J, v0[:, :h], dev, pert, **kw)
            twice = lambda t: torch.cat([t, t], dim=1)  # noqa: E731
            return AnnealResult(twice(r.v_final), twice(r.sigma),
                                twice(r.energy))
        r = orig(J, v0, dev, pert, **kw)
        sigma = r.sigma.clone()
        sigma[0, :, 0] *= -1
        return AnnealResult(r.v_final, sigma, ising_energy(J, sigma))
    return broken


def _sb_fault(fault):
    orig = sb_jax.fused_sb_kernel

    def broken(Jc, x0, y0, **kw):
        if fault == "unchanged":
            return x0.clone()
        if fault == "half":
            h = x0.shape[1] // 2
            x = orig(Jc, x0[:, :h].contiguous(), y0[:, :h].contiguous(),
                     **kw)
            return torch.cat([x, x], dim=1)
        x = orig(Jc, x0, y0, **kw)
        x[0, 0, :10] = -x[0, 0, :10]
        return x
    return broken


def _best_spins_altered():
    orig = api.solve_suite

    def broken(*a, **kw):
        rep = orig(*a, **kw)
        rep.best_sigma[0] = rep.best_sigma[0].copy()
        rep.best_sigma[0][:3] *= -1
        return rep
    return broken


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _measure(tiny_cell(name))
    assert out["correct"], out["compared"]
    assert list(out["compared"])[-1] == "calls_failed"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    if name == "chip64-anneal":
        monkeypatch.setattr(engine, "anneal", _anneal_fault(fault))
    else:
        monkeypatch.setattr(sb_jax, "fused_sb_kernel", _sb_fault(fault))
    out = _measure(tiny_cell(name))
    assert not out["correct"]
    share = out["compared"]["energy_mismatch_share"]
    assert share["value"] > share["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_best_spins_altered_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(api, "solve_suite", _best_spins_altered())
    out = _measure(tiny_cell(name))
    assert not out["correct"]
    assert out["compared"]["best_energy_gap"]["value"] > 0


def test_calls_that_raise_are_not_correct(monkeypatch):
    cell = tiny_cell("g22-sb")
    orig = api.solve_suite
    first = []

    def warm_then_fail(*a, **kw):     # the warm-up call passes
        if not first:
            first.append(1)
            return orig(*a, **kw)
        raise RuntimeError("planted")

    monkeypatch.setattr(api, "solve_suite", warm_then_fail)
    out = _measure(cell, seconds=0.05)
    assert not out["correct"] and out["failed"] > 0
    assert out["compared"]["calls_failed"]["value"] == out["failed"]
    json.dumps(out, allow_nan=False)
