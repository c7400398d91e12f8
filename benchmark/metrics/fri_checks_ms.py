"""Device ms a forward of the program's span "fri_checks"
(TorchVerifier._fri_checks), between its two CUDA events, over the traced
span's steady forwards (traced_report.SETTLE)."""

from traced_report import device_ms


def read(obs):
    return device_ms("fri_checks")
