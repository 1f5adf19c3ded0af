"""The device's idle share of the traced window (%): 100 x (1 - the union
of the device operations' intervals over the window's length)."""


def read(tr):
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
