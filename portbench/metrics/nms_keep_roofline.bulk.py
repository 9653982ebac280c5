"""The keep-mask kernel's share of its roofline in a network cell (%):
the least time of every keep-mask call (`counts.keep_bound_s`) over the
device time of its two kernels, nms_mask_kernel and nms_scan_kernel."""


def read(t):
    k = t.kernel_s("nms_mask_kernel", "nms_scan_kernel")
    if not k or not t.keep_bounds:
        return None
    return 100.0 * sum(t.keep_bounds) / k
