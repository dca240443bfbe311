"""The device's idle time between a fit cell's replays, as a share of the
traced sub-window: idle intervals inside the host intervals of the
trainer's ``train.epoch.steps`` spans (generator seeding and one graph
replay a batch)."""

from harness import spans


def read(view):
    if view.kind != "fit":
        return None
    return spans.idle_share_in(view.trace, ["train.epoch.steps"])
