"""The device's idle share of the traced iterations, in %: 100 (1 -
busy / window), with busy the union of the device's intervals."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
