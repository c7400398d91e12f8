"""The 95th percentile, over every batch of the window, of the time from when
a batch was due (the start of its dispatch) to when its verdict lanes were on
the host."""

import numpy as np


def read(obs):
    lat = [r["done"] - r["due"] for r in obs["records"]]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
