"""Idle share of the device in the untraced training window: 1 - the
traced steps' kernel time a step (the union of kernel spans, which the
profiler's host cost does not stretch) over the window's host-clock time
a step. The traced stretch's own wall clock holds the profiler's host
cost, so it is not the divisor."""

def read(run):
    t, w = run.traced, run.window
    traced = run.counts.get("traced_steps")
    if run.cell["driver"] != "train" or t is None or not traced or not w.get("steps"):
        return None
    return 100.0 * (1.0 - (t.busy_us() / 1e6 / traced) / (w["seconds"] / w["steps"]))
