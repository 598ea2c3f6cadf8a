"""device_idle_share.testset (device, %): the share of the traced window in
which no device operation ran (1 - the union of the device events' intervals
over the window)."""


def read(run):
    tr = run["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
