"""solver_host_ms.<cell kind> (device trace, the solver's host set-up):
the ``SolveReport.wall_s`` of the window's calls less the device's busy
time inside the calls, a call: what the host adds around the kernels
(the anneal's LFSR inits, uploads and readback; SB's c0 / Jc, inits and
float64 energies)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.calls:
        return None
    return 1e3 * (sum(c.report_wall_s for c in ctx.calls)
                  - tr.busy_within_calls_s()) / len(ctx.calls)
