"""Kernels a clip costs: the kernel rows of the traced window (copies and sets
left out) over the clips of its requests."""


def read(run):
    ops = run["timeline"].in_window()
    if not ops or not run.get("clips"):
        return None
    kernels = [o for o in ops if not o[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / run["clips"]
