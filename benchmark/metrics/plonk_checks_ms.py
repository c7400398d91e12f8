"""Device ms a forward of the program's span "plonk_checks"
(TorchVerifier._plonk_checks), between its two CUDA events, the card's idle
time inside it included, over the traced span's steady forwards
(traced_report.SETTLE)."""

from traced_report import device_ms


def read(obs):
    return device_ms("plonk_checks")
