"""device_ms_per_pair.testset (registration program, device trace): the
device's busy time in the traced window (the union of every device
operation's interval: idle time left out) over the pairs traced."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.pairs or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / tr.pairs
