"""Training images per second: the window's steps times the batch over the
time from the first step's start to the synchronize after the last."""


def read(run):
    w = run.window
    return w["items"] / w["seconds"] if run.cell["driver"] == "train" and w.get("items") else None
