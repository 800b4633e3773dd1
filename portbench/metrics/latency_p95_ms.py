"""95th percentile of the window's request latencies: host clock from the
request batch in host memory to its result in host memory, synchronised."""

import numpy as np


def read(w):
    return float(np.percentile(w.latencies, 95)) * 1e3
