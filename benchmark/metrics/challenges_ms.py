"""Device ms a forward of the program's span "challenges" (TorchVerifier:
the public-input hash, the transcript's scan, the powers and inverses),
between its two CUDA events, over the traced span's steady forwards
(traced_report.SETTLE)."""

from traced_report import device_ms


def read(obs):
    return device_ms("challenges")
