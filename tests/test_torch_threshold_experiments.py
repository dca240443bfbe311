"""PyTorch port, clip-rule experiments (``predict/experiments.py``)
against the JAX package's on one fixture tree, on the CPU: the B-line
count experiment (contiguous and total), the sliding-window experiment and
the WaveBase clip predictor. The returned tables and every CSV written
must be the JAX package's byte for byte.

The frame-prediction CSVs are written as the JAX package's
``compute_frame_predictions`` writes them (float32 probabilities, an index
column), and once more with float64 probabilities in 17 digits, which
pandas' default float parser reads differently from Python's ``float`` in
about a third of cases: the port's reader must give pandas' arrays.
"""

import glob
import io
import os

import numpy as np
import pandas as pd
import pytest
import torch

from conftest import REPO_ROOT

from ab_line_classifier_tpu.config import Config as JaxConfig
from ab_line_classifier_tpu.config import load_config
from ab_line_classifier_tpu.predict import experiments as jax_exp
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.ops import clip_aggregation as agg
from ab_line_classifier_torch.predict import experiments as exp
from ab_line_classifier_torch.utils import tables

CLIP_LENGTHS = {"clipA": 3, "clip_b": 17, "c_3": 40, "d": 1, "patient_e": 25,
                "f_long_name": 33, "g": 16, "h": 9}


def frame_table(dtype, seed=0):
    """A frame-prediction table: per clip a run of frames, ``Class`` set
    per clip, B-line probabilities with runs above the thresholds and a
    few exactly at 0.5 and 0.7."""
    rng = np.random.default_rng(seed)
    paths, labels, b = [], [], []
    for i, (clip, n) in enumerate(CLIP_LENGTHS.items()):
        label = i % 2
        p = rng.random(n) * 0.6 + (0.35 if label else 0.05)
        if n > 4:
            p[1] = 0.5
            p[2] = 0.7
        paths += [f"{clip}_{j}.jpg" for j in range(n)]
        labels += [label] * n
        b.append(p)
    b = np.concatenate(b).astype(dtype)
    df = pd.DataFrame({"a_lines": (1 - b).astype(dtype), "b_lines": b})
    df.insert(0, "Frame Path", paths)
    df.insert(1, "Class", labels)
    return df


@pytest.fixture(scope="module", params=["float32", "float64"])
def preds_csv(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("frames") / "test_set_frames.csv")
    frame_table(np.dtype(request.param)).to_csv(path)
    return path


def configs(root, rt_root=""):
    d = load_config(os.path.join(REPO_ROOT, "config.yml")).to_dict()
    d["CLIP_PREDICTION"].update({"CONTIGUITY_THRESHOLD": 3,
                                 "CLASSIFICATION_THRESHOLD": 0.7})
    out = []
    for side in ("jax", "torch"):
        dd = dict(d)
        dd["PATHS"] = dict(d["PATHS"])
        dd["PATHS"].update({
            "RT_ROOT_DIR": rt_root,
            "EXPERIMENTS": os.path.join(root, side, "experiments"),
            "EXPERIMENT_VISUALIZATIONS": os.path.join(root, side, "viz"),
            "BATCH_PREDS": os.path.join(root, side, "preds"),
            "CLASS_NAME_MAP": os.path.join(root, "missing.json")})
        out.append(dd)
    return JaxConfig(out[0]), Config(out[1])


def table_csv(rows, path):
    """The port's table rows as its writer writes them."""
    tables.write_csv(str(path), rows)
    with open(path) as f:
        return f.read()


def same_files(root, pattern):
    """Each file matching ``pattern`` under the two sides' directories,
    byte-equal, in name order (timestamps stripped)."""
    a = sorted(glob.glob(os.path.join(root, "jax", pattern)))
    b = sorted(glob.glob(os.path.join(root, "torch", pattern)))
    assert len(a) == len(b) >= 1, (a, b)
    for x, y in zip(a, b):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read(), (x, y)


def test_read_table_gives_pandas_arrays(preds_csv):
    want = pd.read_csv(preds_csv)
    got = tables.read_table(preds_csv)
    assert list(got) == list(want.columns) == [
        "Unnamed: 0", "Frame Path", "Class", "a_lines", "b_lines"]
    for c in want.columns:
        if want[c].dtype.kind in "if":
            assert got[c].dtype == want[c].dtype, c
            np.testing.assert_array_equal(got[c], want[c].to_numpy())
        else:
            assert list(got[c]) == list(want[c]), c


def test_parse_float_is_pandas_parser():
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.random(4000), rng.random(2000) * 1e-4,
                           rng.random(2000) * 1e3, -rng.random(1000),
                           rng.random(1000) * 1e-9])
    strs = ([repr(float(v)) for v in vals] + [str(np.float32(v)) for v in
                                               vals[:3000]]
            + ["1e-05", "2.5E+3", "0", "-0.0", "12345678901234567890.5"])
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(strs)))["x"].to_numpy()
    got = np.array([tables.parse_float(s) for s in strs])
    np.testing.assert_array_equal(got, want)
    assert (got != np.array([float(s) for s in strs])).any(), \
        "pandas' parser should differ from float() somewhere"


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("class_thresh", [0.5, 0.7])
def test_b_line_threshold_experiment_matches_jax(preds_csv, tmp_path,
                                                 contiguous, class_thresh):
    jcfg, tcfg = configs(str(tmp_path))
    want = jax_exp.b_line_threshold_experiment(
        jcfg, preds_csv, 1, 8, class_thresh=class_thresh,
        contiguous=contiguous, document=True)
    got = exp.b_line_threshold_experiment(
        tcfg, preds_csv, 1, 8, class_thresh=class_thresh,
        contiguous=contiguous, document=True, device="cpu")
    assert table_csv(got, tmp_path / "got.csv") == want.to_csv(index=False)
    for pattern in ("experiments/preds.csv",
                    "experiments/b-line_thresholds_*.csv",
                    "experiments/clip_contiguous_preds_*.csv"):
        same_files(str(tmp_path), pattern)
    for name in ("threshold_exp_*.png", "threshold_roc_*.png"):
        assert glob.glob(os.path.join(str(tmp_path), "torch", "viz", name))


@pytest.mark.parametrize("class_thresh", [0.5, 0.7])
def test_sliding_window_experiment_matches_jax(preds_csv, tmp_path,
                                               class_thresh):
    jcfg, tcfg = configs(str(tmp_path))
    want = jax_exp.sliding_window_variation_experiment(
        jcfg, preds_csv, 1, 20, class_thresh=class_thresh, document=True)
    got = exp.sliding_window_variation_experiment(
        tcfg, preds_csv, 1, 20, class_thresh=class_thresh, document=True,
        device="cpu")
    assert table_csv(got, tmp_path / "got.csv") == want.to_csv(index=False)
    for pattern in ("experiments/sliding_window_exp_*.csv",
                    "experiments/clip_sliding_window_preds_*.csv"):
        same_files(str(tmp_path), pattern)
    assert glob.glob(os.path.join(str(tmp_path), "torch", "viz",
                                  "threshold_exp_*.png"))


def test_prefix_sum_is_xla_order_on_any_length():
    """The sliding window's prefix sum adds in XLA's order, so its clip
    probabilities are the JAX package's bit for bit."""
    import jax.numpy as jnp
    for t in (1, 15, 16, 17, 255, 256, 257, 1000):
        x = np.random.default_rng(t).random((3, t)).astype(np.float32)
        np.testing.assert_array_equal(
            agg.prefix_sum(torch.from_numpy(x)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))


def _wb_rows(rows):
    return pd.DataFrame(rows).astype(str)


def test_contiguity_rule_as_jax():
    cases = [([["B-Lines", "0.9"], ["A-Lines", "0.9"], ["B-Lines", "0.95"],
               ["B-Lines", "0.8"]], 3, 0.7),
             ([["B-Lines", "0.9"], ["A-Lines", "0.9"], ["B-Lines", "0.95"],
               ["B-Lines", "0.8"]], 2, 0.7),
             ([["B-Lines", "0.9"], ["B-Lines", "0.7"], ["B-Lines", "0.9"]],
              2, 0.7),
             ([["B-Lines", "0.9"], ["B-Lines", "0.71"], ["B-Lines", "0.9"]],
              2, 0.7)]
    for rows, ct, thr in cases:
        assert exp.predict_clipwise_with_contiguity_threshold_wb(
            rows, "B-Lines", ct, thr) == \
            jax_exp.predict_clipwise_with_contiguity_threshold_wb(
                _wb_rows(rows), "B-Lines", ct, thr)


def test_compute_clip_predictions_wb_matches_jax(tmp_path):
    root = tmp_path / "rt_root"
    rng = np.random.default_rng(3)
    for day in ("2024-01-05", "2024-02-11"):
        rec = root / day / "recordings" / "probe1"
        rec.mkdir(parents=True)
        for k in range(4):
            n = int(rng.integers(3, 30))
            # Odd clips mostly confident B-line frames, even ones not.
            cls = rng.choice(["B-Lines", "A-Lines"], n,
                             p=[0.9, 0.1] if k % 2 else [0.5, 0.5])
            prob = np.round(rng.uniform(0.6 if k % 2 else 0.0, 1.0, n), 3)
            _wb_rows(np.stack([cls, prob.astype(str)], 1).tolist()).to_csv(
                rec / f"clip{k}_probs.csv", index=False, header=False)
    jcfg, tcfg = configs(str(tmp_path), rt_root=str(root))
    want = jax_exp.compute_clip_predictions_wb(jcfg)
    got = exp.compute_clip_predictions_wb(tcfg)
    assert [tuple(r) for r in want.to_numpy().tolist()] == got
    assert {p for _, p in got} == {"A-Line", "B-Line"}
    same_files(str(tmp_path), "preds/rt_root_clip_predictions_T3_t07_*.csv")
