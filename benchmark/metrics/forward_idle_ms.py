"""The card idle while the host was inside a forward: device ms a forward of
the program's span "forward" (from the card reaching its first event to its
last) over the traced span's steady forwards (traced_report.SETTLE), less
the device's busy ms a forward over the profiled span (the union of its
kernel, copy and set intervals, profiled.py). The rest of device_idle_share
lies between forwards: the harness's wait and copies."""

from traced_report import device_ms


def read(obs):
    forward, span = device_ms("forward"), obs["span"]
    return forward - span["busy_s_a_forward"] * 1e3 if forward is not None and span else None
