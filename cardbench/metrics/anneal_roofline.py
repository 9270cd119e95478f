"""anneal_roofline (device trace, kernels): the least time the card could
take for the window's anneals (``harness.roofline``: 2 R operations a
nonzero coupling a step at which its column's scale is nonzero, at the
int8 peak, since J is integer levels and the spins +-1, or the bytes at
HBM bandwidth, the larger) over the anneal kernel's device time. Silent
where no anneal kernel ran."""
from cardbench.harness import roofline

KERNELS = ("anneal_f32_", "anneal_mma")


def _share(ctx, peak):
    cfg = ctx.cell.config
    work = roofline.anneal_work(
        ctx.problems, int(ctx.cell.traffic["runs"]), cfg["chip"],
        cfg["variants"][ctx.cell.traffic["solver_opts"]["variant"]])
    return roofline.kernel_share(ctx, KERNELS, work, peak)


def read(ctx):
    return _share(ctx, "int8")[0]


def info(ctx):
    share, secs, launches = _share(ctx, "float32")
    return {"kernel_s": secs, "launches": launches, "calls": len(ctx.calls),
            "share_of_f32_peak_pct": share}
