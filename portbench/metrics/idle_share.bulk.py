"""Idle share of the card over the traced window of a network cell (%):
1 - the union of device operation intervals over the window."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s)
