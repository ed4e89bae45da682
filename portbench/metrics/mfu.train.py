"""The training step's share of the card's dense bf16 peak: forward and
backward operations of the DDPM loss per image (the reference's shapes)
times the window's images, over the window's seconds."""


def read(run):
    peak = run.peak()
    if run.cell["driver"] != "train" or not peak or not run.flops.get("window"):
        return None
    return 100.0 * run.flops["window"] / run.window["seconds"] / peak["bfloat16_flops"]
