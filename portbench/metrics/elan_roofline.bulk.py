"""The fused group kernel's share of its roofline in a network cell (%):
the least time of every group call (`counts.group_bound_s`) over the
device time of the kernels whose name holds fused_elan."""


def read(t):
    k = t.kernel_s("fused_elan")
    if not k or not t.group_bounds:
        return None
    return 100.0 * sum(t.group_bounds) / k
