"""cudaLaunchKernel runtime calls over the profiled span, divided by its
forwards."""


def read(obs):
    span = obs["span"]
    return span["launches"] / span["forwards"] if span and span["launches"] else None
