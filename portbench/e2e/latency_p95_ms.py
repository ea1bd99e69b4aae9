"""95th percentile (linear between ranks), over every request completed
in the window, of the host-clock time from the call to its return."""

import numpy as np


def read(window, setup_s):
    lat = [(r.end - r.start) * 1e3 for r in window.requests
           if r.start is not None]
    return float(np.percentile(lat, 95)) if lat else None
