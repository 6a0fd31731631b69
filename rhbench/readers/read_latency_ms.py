"""A quantile of the reads' latency: for each read of the window, the time
from the engine taking its batch to the batch's results coming back, in
ms; numpy's linear interpolation between the closest ranks."""

import numpy as np


def read(ctx, quantile: float):
    lat = np.asarray(ctx["latency_ms"], dtype=np.float64)
    return float(np.percentile(lat, 100.0 * quantile)) if lat.size else None
