"""The roofline arithmetic and every metric reader on a small synthetic
trace."""
from __future__ import annotations

import numpy as np
import pytest

from cardbench_util import cell
from cardbench.harness import problems as gen, roofline, spec
from cardbench.harness.loop import Call, Context
from cardbench.harness.trace import Trace, _outermost

ANNEAL = "(anonymous namespace)::anneal_f32_registers(float const*, ...)"
SB = "(anonymous namespace)::sb_cluster(float const*, ...)"


CHIP = {"vdd": 1.0, "cols_per_tile": 64, "substeps": 8,
        "anneal_sweeps": 3.75, "drive": 1.0, "tau_leak_sweeps": 10.0,
        "init_swing": 0.5}
PERT = {"period_slots": 48, "off_slots": 8, "settle_sweeps": 1.0,
        "leak": True}
GD = {"period_slots": 48, "off_slots": 0, "settle_sweeps": 1.0,
      "leak": False}


def _sparse(n, nnz_rows):
    """(n, n) levels with ``nnz_rows[i]`` nonzeros in column i."""
    J = np.zeros((n, n), np.float32)
    for j, k in enumerate(nnz_rows):
        J[:k, j] = 3.0
    return J


def test_anneal_work_counts_nonzeros_at_active_steps():
    from cardbench.reference.anneal import schedule
    J = _sparse(64, [j % 7 for j in range(64)])
    nnz = int(np.count_nonzero(J))
    # ideal refresh, no gating: every nonzero at every one of 1920 steps
    ops, nbytes = roofline.anneal_work([J, J], 1000, CHIP, GD)
    assert ops == 2 * 2 * 1000 * nnz * 1920
    assert nbytes == 2 * (8 * nnz + 8 * 1000 * 64)
    # gated rails: a column adds nothing at a step its scale reads 0
    scale = schedule(CHIP, PERT, 64, "cpu").numpy()
    want = sum(2 * 1000 * np.count_nonzero(J[:, j]) for t in range(1920)
               for j in range(64) if scale[t, j] != 0)
    ops, _ = roofline.anneal_work([J], 1000, CHIP, PERT)
    assert ops == want and 0.75 * nnz * 2000 * 1920 < ops < nnz * 2000 * 1920
    assert roofline.bound_s(ops, nbytes, "int8") == ops / 1979e12


def test_sb_work_counts_nonzero_couplings_of_real_spins():
    J = _sparse(200, [5] * 200)
    ops, nbytes = roofline.sb_work([J], 1024, 400)
    assert ops == 2 * 1024 * 1000 * 400
    assert nbytes == 8 * 1000 + 12 * 1024 * 200
    # far under the dense count, which a sparse kernel would beat
    assert ops < 0.03 * 2 * 1024 * 200 * 200 * 400
    # a memory-bound shape takes the bandwidth's side of the bound
    ops, nbytes = roofline.sb_work([J], 1, 1)
    assert roofline.bound_s(ops, nbytes, "bfloat16") == nbytes / 3.35e12


def _trace():
    """Two calls of 10 ms (us 0-10000, 12000-22000), a window of 0.025 s;
    kernels 2-6 ms and 14-18 ms (the second overlapping a copy 17-19 ms)."""
    device = [(ANNEAL, 2000.0, 6000.0), (ANNEAL, 14000.0, 18000.0),
              ("Memcpy DtoH (Device -> Pageable)", 17000.0, 19000.0)]
    host = [(0.0, 1500.0, "aten::to"), (100.0, 200.0, "aten::copy_"),
            (6500.0, 9000.0, "aten::resolve_neg"),
            (12000.0, 13500.0, "aten::to")]
    return Trace(device, [(0.0, 10000.0), (12000.0, 22000.0)],
                 _outermost(host))


def _ctx(name, trace=None):
    c = cell(name)
    calls = [Call(1, 0.010, 0.009, 20000), Call(2, 0.010, 0.008, 20000)]
    return Context(c, gen.make_problems(c.config, c.traffic, 1), 5.0,
                   0.025, calls, trace)


def test_trace_busy_and_gaps():
    tr = _trace()
    assert tr.busy_s == pytest.approx(0.009)
    assert tr.busy_within_calls_s() == pytest.approx(0.009)
    assert [h[2] for h in tr.host] == ["aten::to", "aten::resolve_neg",
                                       "aten::to"]
    # each gap is named by what the host did at its middle: 0-2 ms in the
    # first aten::to; 6-14 ms (middle 10 ms, the first call's last
    # instant) after resolve_neg; 19-22 ms after the second aten::to
    assert tr.idle_gaps() == [
        ["after aten::resolve_neg", pytest.approx(0.008)],
        ["after aten::to", pytest.approx(0.003)],
        ["in aten::to", pytest.approx(0.002)]]
    tr.calls = [(0.0, 9000.0), (12000.0, 22000.0)]
    assert dict(tr.idle_gaps())["between calls: after aten::resolve_neg"] \
        == pytest.approx(0.008)
    assert tr.device_ops()[0] == [ANNEAL[:120], pytest.approx(0.008)]


def test_host_clock_readers():
    ctx = _ctx("chip64-anneal")
    read = lambda m: spec.reader(m).read(ctx)  # noqa: E731
    assert read("setup_s") == 5.0
    assert read("anneals_per_s") == pytest.approx(40000 / 0.025)
    assert read("api_overhead_ms.anneal") == pytest.approx(1.5)
    assert read("call_p95_ms.anneal") is None          # under 20 calls
    ctx.calls = [Call(i, 0.001 * (i + 1), 0.0, 1) for i in range(40)]
    assert read("call_p95_ms.anneal") == pytest.approx(38.95)


def test_trace_readers_silent_without_a_device_trace():
    ctx = _ctx("chip64-anneal")
    for m in ("solver_host_ms.anneal", "device_idle_pct.anneal",
              "anneal_roofline"):
        assert spec.reader(m).read(ctx) is None
    ctx.trace = Trace([], [(0.0, 1.0)], [])
    assert spec.reader("device_idle_pct.anneal").read(ctx) is None


def test_trace_readers():
    ctx = _ctx("chip64-anneal", _trace())
    read = lambda m: spec.reader(m).read(ctx)  # noqa: E731
    assert read("device_idle_pct.anneal") == pytest.approx(64.0)
    assert read("solver_host_ms.anneal") == pytest.approx((0.017 - 0.009)
                                                          * 1e3 / 2)
    ops, nbytes = roofline.anneal_work(ctx.problems, 1000, CHIP, PERT)
    want = 100 * 2 * roofline.bound_s(ops, nbytes, "int8") / 0.008
    assert read("anneal_roofline") == pytest.approx(want)
    info = spec.reader("anneal_roofline").info(ctx)
    assert info["launches"] == 2 and info["share_of_f32_peak_pct"] == \
        pytest.approx(want * 1979 / 67)
    # no SB kernel ran: its roofline stays silent
    ctx = _ctx("g22-sb", _trace())
    assert spec.reader("sb_roofline").read(ctx) is None


def test_sb_roofline_reads_the_sb_kernel():
    tr = Trace([(SB, 0.0, 400000.0)], [(0.0, 500000.0)], [])
    ctx = _ctx("g22-sb", tr)
    ctx.calls = ctx.calls[:1]
    J, = ctx.problems
    nnz = np.count_nonzero(J)
    assert 0.009 < nnz / J.size < 0.011          # G22's density
    ops = 2.0 * 1024 * nnz * 400
    assert spec.reader("sb_roofline").read(ctx) == pytest.approx(
        100 * ops / 989e12 / 0.4)
    info = spec.reader("sb_roofline").info(ctx)
    assert info["share_of_f32_peak_pct"] == pytest.approx(
        100 * ops / 67e12 / 0.4)
