"""The whole scoring step's share of the card's dense bf16 peak: the
useful operations of the window's batches (each start point's own UNet
steps, the encode, one decode and LPIPS of each reconstruction, counted
on the reference's shapes) over the window's seconds."""


def read(run):
    peak = run.peak()
    if run.cell["driver"] != "score" or not peak or not run.flops.get("window"):
        return None
    return 100.0 * run.flops["window"] / run.window["seconds"] / peak["bfloat16_flops"]
