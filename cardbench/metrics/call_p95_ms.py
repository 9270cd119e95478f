"""call_p95_ms.<cell kind> (host clock, API layer): the 95th percentile
of the harness's wall of a call over every call of the window."""
import statistics


def read(ctx):
    if len(ctx.calls) < 20:
        return None
    return 1e3 * statistics.quantiles([c.wall_s for c in ctx.calls],
                                      n=20)[18]
