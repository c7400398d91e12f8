"""The host's dispatch time in `TorchVerifier.forward` a batch: from the
batch's dispatch to the return of its enqueue (the harness's clock), less the
time spent inside CUDA runtime and driver calls (the profiler's trace), over
the traced span's batches: the Python and PyTorch work of the verifier's
entry layer. The host's waits on the card (a synchronisation, a copy to the
host, a launch into a full queue) all fall inside such calls and do not
count; nor does the runtime's own cost a launch."""


def read(obs):
    span = obs["span"]
    return span["dispatch_s_a_forward"] * 1e3 if span else None
