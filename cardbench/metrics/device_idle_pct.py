"""device_idle_pct.<cell kind> (device trace): the share of the traced
window in which no device activity ran."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx.window_s)
