"""Share of the traced training steps' kernel time in kernels launched by
the GroupNorm backward (inside autograd's ``_GroupNormActBackward`` node),
attributed through the autograd tree."""


def read(run):
    t = run.traced
    if run.cell["driver"] != "train" or t is None or not t.kernels:
        return None
    part = t.under(lambda name: "_GroupNormActBackward" in name)
    return 100.0 * part / sum(b - a for a, b, *_ in t.kernels) if part else None
