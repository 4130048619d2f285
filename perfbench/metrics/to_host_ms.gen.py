"""Host ms a call waits after `sample_raw` has returned until its images are a
numpy array on the host (the card finishing the call, then the copy), a
call, over the untraced part of the window."""


def read(ctx):
    h = ctx.host
    return (sum(h["latency_s"]) - sum(h["sample_raw_s"])) / h["units"] * 1e3
