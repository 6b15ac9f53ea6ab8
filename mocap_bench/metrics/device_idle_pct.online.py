"""The share of the traced window, %, in which no kernel or copy runs on
the device."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 and t.kernels else None
