"""device_idle_share (device layer): the share of the traced window in
which no kernel, copy or set ran on the device."""

from gjbench import tracing


def read(trace):
    if not trace["device_ops"]:
        return None
    return 100.0 * (1.0 - tracing.busy_us(trace) / tracing.window_us(trace))
