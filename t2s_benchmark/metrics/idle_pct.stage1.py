"""Share of the traced window in which no operation ran on the device: 100 x
(1 - the union of the device's operation intervals / the window)."""


def read(run):
    return run["timeline"].idle_pct()
