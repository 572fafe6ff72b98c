"""prep_device_ms.rate: device milliseconds a request outside the
decision's kernels (every kernel and copy of the traced window but the
decision's split and reduce kernels, over the window's requests). It
does not part device work by the program span that launched it: in the
bulk cells the only such work today is the queries' pad, cast and norms,
launched inside ``repro_torch.scorer.stage`` and
``repro_torch.decision.prepare`` (``bench/tools/spans_check.py`` joins
each device interval to the span around its launch); any other device
work a later program adds counts here too."""
from benchlib.readers import decision_kernel_s


def read(ctx):
    t, requests = ctx["trace"], ctx["window"].get("requests")
    decision = decision_kernel_s(t)
    if decision is None or not requests:
        return None
    every = sum(s for _, s in t["kernels"].values())
    return 1e3 * max(0.0, every - decision) / requests
