"""Share of the Stage-1 window's device time spent converting between the
NCHW and NHWC layouts: the kernels whose names say so (cuDNN's
``nchwToNhwc`` / ``nhwcToNchw``), over all device time."""


def read(run):
    if "stage1_step_ops" not in run:
        return None
    ops = run["timeline"].in_window()
    total = sum(e - s for _, s, e in ops)
    if total <= 0:
        return None
    layout = sum(e - s for n, s, e in ops if "nchwToNhwc" in n or "nhwcToNchw" in n)
    return 100.0 * layout / total
