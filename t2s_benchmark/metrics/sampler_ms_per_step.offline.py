"""Milliseconds a sampler step takes: the synchronized ``sampler`` spans around
the program's sampler call, summed, over the steps they ran."""


def read(run):
    spans = run["timeline"].spans_named("sampler")
    if not spans:
        return None
    return 1e-6 * sum(e - s for s, e in spans) / (len(spans) * run["steps_per_request"])
