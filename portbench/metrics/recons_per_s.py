"""(images x start points) scored per second: every reconstruction of every
batch of the window over the time from the first batch's start to the last
batch's scores on the host."""


def read(run):
    w = run.window
    return w["items"] / w["seconds"] if run.cell["driver"] == "score" and w.get("items") else None
