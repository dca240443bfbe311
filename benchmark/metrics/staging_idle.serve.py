"""The device's idle time while the host prepares and stages a chunk
served from host memory, as a share of the traced sub-window: idle
intervals inside the host intervals of ``serve.pad`` (the ragged chunk's
padding), ``staging.wait`` (a pinned slot's previous upload) and
``staging.copy`` (the host copy into the pinned buffer and the upload's
enqueue)."""

from harness import spans


def read(view):
    if view.kind != "serve":
        return None
    return spans.idle_share_in(view.trace, ["serve.pad", "staging.wait",
                                            "staging.copy"])
