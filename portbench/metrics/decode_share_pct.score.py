"""Share of the traced stretch's kernel time in kernels launched inside the
benchmark's ``portbench.decode`` span around the VQ-VAE decode."""


def read(run):
    t = run.traced
    if run.cell["driver"] != "score" or t is None or not t.kernels:
        return None
    part = t.under(lambda name: name == "portbench.decode")
    return 100.0 * part / sum(b - a for a, b, *_ in t.kernels) if part else None
