"""The device's idle share in the traced sub-window of a serve cell: one less
the union of its kernels', memcpys' and memsets' intervals over the
sub-window's length."""


def read(view):
    if view.kind != "serve" or view.trace is None or view.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
