"""device.idle_share (read as ``device.idle_share.build`` and
``.query``, one entry for each end-to-end metric it moves): the device's
idle share over the profiled part of a window, one less the union of the
device's operations (torch.profiler) over the host time of the profiled
calls."""


def read(win):
    if not win.busy_s or not win.traced_s:
        return None
    return 100.0 * (1.0 - win.busy_s / win.traced_s)
