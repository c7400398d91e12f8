"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(obs):
    return obs["window_peak_bytes"] / 2**30 if obs["on_card"] else None
