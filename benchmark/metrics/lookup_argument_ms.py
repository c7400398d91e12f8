"""Device ms a forward of the program's leaf span "plonk: lookup argument"
(TorchVerifier._plonk_checks: the lookup argument's one launch,
csrc/plonk.cu p2v_lookup_checks), between its two CUDA events, over the
traced span's steady forwards (traced_report.SETTLE)."""

from traced_report import device_ms


def read(obs):
    return device_ms("plonk: lookup argument")
