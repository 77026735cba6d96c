"""The whole request's share of the chip's peak: each part's operations at the
peak of the precision it runs in (int8 dots, bf16 attention and head, TF32
convolutions of the codec and the vocoder, f32 text tower), counted from the
configuration's shapes, for every request of the traced window, over the
window."""

from t2s_benchmark import roofline


def read(run):
    if not run.get("requests") or "request_ops" not in run:
        return None
    least = run["requests"] * roofline.least_seconds(run["request_ops"])
    return 100.0 * least / run["timeline"].window_s
