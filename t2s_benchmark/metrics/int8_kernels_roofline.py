"""The int8 engine's share of its roofline: the least time of the sampler's
steps at the published peaks (``roofline.int8_step_bound``: each site's bytes
at 3.35 TB/s or its int8 / bf16 products and f32 work at their peaks,
whichever is larger; K2 included), over the device time of the operations
that start inside the synchronized ``sampler`` spans."""


def read(run):
    tl = run["timeline"]
    spans = tl.spans_named("sampler")
    if not spans or "int8_step_bound_s" not in run:
        return None
    device_s = 1e-9 * sum(e - s for a, b in spans for _, s, e in tl.device_in(a, b))
    if device_s <= 0:
        return None
    return 100.0 * len(spans) * run["steps_per_request"] * run["int8_step_bound_s"] / device_s
