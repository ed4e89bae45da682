"""Share of the traced stretch's kernel time in kernels launched inside the
benchmark's ``portbench.unet`` span around the program's UNet calls."""


def read(run):
    t = run.traced
    if run.cell["driver"] != "score" or t is None or not t.kernels:
        return None
    total = sum(b - a for a, b, *_ in t.kernels)
    return 100.0 * t.under(lambda name: name == "portbench.unet") / total
