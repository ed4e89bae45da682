"""Idle share of the device in the traced scoring stretch: 1 - the union of
kernel spans over the stretch's host-clock seconds."""


def read(run):
    t = run.traced
    if run.cell["driver"] != "score" or t is None or not run.traced_s:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / run.traced_s)
