"""Milliseconds a clip spends in the codec's decoder and the vocoder: the
synchronized ``decode`` and ``vocode`` spans, summed, over the clips."""


def read(run):
    tl = run["timeline"]
    spans = tl.spans_named("decode") + tl.spans_named("vocode")
    if not spans or not run["clips"]:
        return None
    return 1e-6 * sum(e - s for s, e in spans) / run["clips"]
