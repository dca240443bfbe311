"""The device's idle time at a fit cell's epoch boundaries, as a share of
the traced sub-window: idle intervals inside the host intervals of the
trainer's ``train.epoch`` spans less its ``train.epoch.steps`` spans (the
tables' upload, the metrics' reset and the synchronizing readback). With
``replay_idle.fit`` and the caller's time outside ``train.epoch`` it makes
up ``idle_share.fit``."""

from harness import spans


def read(view):
    if view.kind != "fit":
        return None
    return spans.idle_share_in(view.trace, ["train.epoch"],
                               less=["train.epoch.steps"])
