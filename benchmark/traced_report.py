"""The program's own tracer (plonky2_verifier_tpu_torch/tracing.py), as the
per-layer metrics of its spans and counter read it: its report over the
forwards it recorded, which are the traced span's (profiled.py), since the
tracer records while a profiler runs and no other forward of a run does.
None where the program has no tracer, or where it recorded no forward (off
the card the span is not profiled)."""

SETTLE = 2  # as profiled.summarize: the span's first forwards start from an idle card, the rest queue behind the one before


def report():
    try:
        from plonky2_verifier_tpu_torch import tracing
    except ImportError:
        return None
    rep = tracing.report()
    return rep if rep["forwards"] else None


def device_ms(name: str):
    """Device ms a forward of the spans `name`, over the steady forwards (all
    but the first SETTLE, where there are more), or None."""
    rep = report()
    if rep is None:
        return None
    raw = rep["raw"]

    def forward_of(s):
        while s is not None and s["name"] != "forward":
            s = raw[s["parent"]] if s["parent"] is not None else None
        return s

    forwards = sorted(s["request"] for s in raw if s["name"] == "forward")
    steady = set(forwards[SETTLE:] if len(forwards) > SETTLE else forwards)
    spans = [s for s in raw if s["name"] == name and s["device_ns"] and (forward_of(s) or {}).get("request") in steady]
    return sum(s["device_ns"][1] - s["device_ns"][0] for s in spans) / 1e6 / len(steady) if spans else None
