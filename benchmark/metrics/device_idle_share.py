"""1 - (union of the device's kernel, copy and set intervals) / wall time,
over the profiled span's steady part (profiled.py)."""


def read(obs):
    span = obs["span"]
    return 1.0 - span["busy_s"] / span["window_s"] if span and span["window_s"] > 0 else None
