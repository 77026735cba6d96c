"""The Stage-1 step's share of the chip's peak: the TF32 operations of every
step of the traced window (the codec's, LPAPS's and the PatchGAN's forwards
and backwards in both phases, counted once at set-up with
``torch.utils.flop_counter`` on the benchmark's plain references over meta
tensors), at the TF32 peak, over the window."""

from t2s_benchmark import roofline


def read(run):
    if not run.get("steps") or "stage1_step_ops" not in run:
        return None
    least = run["steps"] * roofline.least_seconds(run["stage1_step_ops"])
    return 100.0 * least / run["timeline"].window_s
