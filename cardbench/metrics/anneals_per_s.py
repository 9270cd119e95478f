"""anneals_per_s (host clock): anneal runs completed in the window
(problems x runs of every call that returned) over the window's length.
Every rate of runs reads so (``sb_restarts_per_s`` imports this)."""


def read(ctx):
    return sum(c.runs for c in ctx.calls) / ctx.window_s if ctx.calls \
        else None
