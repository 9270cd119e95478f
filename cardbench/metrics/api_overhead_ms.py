"""api_overhead_ms.<cell kind> (host clock, API layer): the harness's wall
of a call minus the ``SolveReport.wall_s`` the solve API measured around
its buckets (the registry's solver lookup and set-up, bucketing of the
suite, scatter of the answers), averaged over the window's calls."""


def read(ctx):
    if not ctx.calls:
        return None
    return 1e3 * sum(c.wall_s - c.report_wall_s for c in ctx.calls) \
        / len(ctx.calls)
