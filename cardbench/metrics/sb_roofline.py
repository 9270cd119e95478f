"""sb_roofline (device trace, kernels): the least time the card could take
for the window's SB integrations (``harness.roofline``: 2 R operations a
nonzero coupling a step, over the real spins, at the bf16 peak, the
highest dense rate an exact split of float32 operands could use, or the
bytes at HBM bandwidth, the larger) over the SB kernel's device time.
Silent where no SB kernel ran."""
from cardbench.harness import roofline

KERNELS = ("sb_cluster", "sb_resident")


def _share(ctx, peak):
    work = roofline.sb_work(
        ctx.problems, int(ctx.cell.traffic["runs"]),
        int(ctx.cell.traffic["solver_opts"]["n_steps"]))
    return roofline.kernel_share(ctx, KERNELS, work, peak)


def read(ctx):
    return _share(ctx, "bfloat16")[0]


def info(ctx):
    share, secs, launches = _share(ctx, "float32")
    return {"kernel_s": secs, "launches": launches, "calls": len(ctx.calls),
            "share_of_f32_peak_pct": share}
