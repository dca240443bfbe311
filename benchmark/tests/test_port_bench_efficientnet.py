"""The cell ``efficientnetb7-serve-study`` driven on the CPU at a tiny
traffic: the harness takes the new configuration, mix, limits and reader as
files and entries, and a sound run is correct."""

import importlib
import time

import torch

import run as bench_run
from harness import cells

CPU = torch.device("cpu")
CELL = "efficientnetb7-serve-study"


def test_a_sound_efficientnet_run_is_correct():
    cell = cells.load(CELL)
    assert cell.traffic["driver"] == "serve" and cell.chips == 1
    assert "pointwise_share.serve" in [m.name for m in cell.per_layer]
    cell.traffic.update(chunk=4, pool_chunks=2, frame_hw=[96, 128],
                        trace_seconds=0.01)
    cell.config["input_shape"] = [64, 64, 3]  # the cell's is 600x600
    driver = importlib.import_module("harness.serve")
    outcome = driver.run(cell, 2**32 + 5, 0.2, True, CPU,
                         time.perf_counter())
    result = bench_run.result_line(cell, outcome, True, CPU)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert outcome.view.work["b2_layers"] == 51
    assert outcome.view.trace is not None
