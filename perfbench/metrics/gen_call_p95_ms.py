"""95th percentile of the window's call times, ms: from the start of
`sample_raw` to the images as a numpy array on the host."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.host["latency_s"]) * 1e3, 95))
