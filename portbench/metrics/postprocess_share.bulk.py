"""Device time of the work launched inside the postprocess span (the
detector's `postprocess`: gate, top-K, gathers, the keep mask) over the
window's device-busy time (%)."""


def read(t):
    s = t.span_device_s("postprocess")
    if s is None or not t.busy_s:
        return None
    return 100.0 * s / t.busy_s
