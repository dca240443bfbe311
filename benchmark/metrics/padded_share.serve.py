"""The share of the rows a serve cell sent through the program that were
zero rows padding its ragged chunks, over the traced sub-window: the
deltas of the predictor's ``rows_padded`` and ``rows_run`` counters, which
``harness/serve_host.py`` puts into the view's work."""


def read(view):
    run = view.work.get("rows_run")
    if view.kind != "serve" or not run:
        return None
    return 100.0 * view.work["rows_padded"] / run
