"""GroupNorm's share of its roofline in the traced stretch: the least time
of the UNet's GroupNorms (x read once and y written once, from the
reference's GroupNorm inputs, times the rows the traced UNet calls took, at
the card's memory bandwidth) over the time of kernels named
``groupnorm_act``."""


def read(run):
    t, peak = run.traced, run.peak()
    if run.cell["driver"] != "score" or t is None or not peak:
        return None
    kernel_us = t.kernel_us("groupnorm_act")
    if not kernel_us or not run.counts.get("traced_rows"):
        return None
    least_s = run.counts["traced_rows"] * run.flops["gn_bytes_per_row"] / peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (kernel_us / 1e6)
