"""Host-device synchronisations inside the program's span "forward", a
forward, over the traced span's forwards: the tracer's count of
torch.cuda.set_sync_debug_mode("warn")'s warnings (tracing.py)."""

from traced_report import report


def read(obs):
    rep = report()
    return rep["syncs_per_forward"] if rep else None
