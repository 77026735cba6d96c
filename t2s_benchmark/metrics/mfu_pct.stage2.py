"""The Stage-2 step's share of the chip's peak: the operations of every step
of the traced window (the denoiser's forward and backward and the text
tower in f32, the codec's encoder in TF32, counted from the configuration's
shapes) at those precisions' peaks, over the window."""

from t2s_benchmark import roofline


def read(run):
    if not run.get("steps") or "stage2_step_ops" not in run:
        return None
    least = run["steps"] * roofline.least_seconds(run["stage2_step_ops"])
    return 100.0 * least / run["timeline"].window_s
