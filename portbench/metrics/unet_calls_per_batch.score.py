"""UNet calls a scoring batch makes (``ReconProgram.model_evals`` over the
window's batches): a count, which moves when lane groups change."""


def read(run):
    calls, batches = run.counts.get("unet_calls"), run.window.get("batches")
    return calls / batches if calls and batches else None
