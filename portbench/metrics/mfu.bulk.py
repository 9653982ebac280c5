"""The forward FLOPs of every call completed in the traced window, counted
on the reference model on the meta device at the call's shape, over the
window times the bf16 peak (%)."""

from portbench import counts


def read(t):
    return 100.0 * t.flops / (t.window_s * counts.BF16_FLOPS)
