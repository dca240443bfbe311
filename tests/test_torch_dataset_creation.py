"""PyTorch port, dataset creation (``data/synthetic.py``,
``data/dataset_creator.py``, ``data/ab_line_dataset_creator.py``,
``data/real_time.py``) against the JAX package's.

Every table the port writes is compared byte for byte with the file the
JAX package (pandas) writes from the same inputs: the synthetic dataset's
CSVs and JPEGs for one seed, the labelled query table, the real-time clips
table (pandas' outer merge: sorted keys, a class column made float by
missing cells) and the real-time and retrospective frames tables. With an
injected fetch, a ``URLError`` is counted, its ``.part`` removed and the
pulled clips equal the JAX creator's. The whole creator runs on the CPU
with an injected query and fetch (local copies) and a seeded U-Net: the
clips are masked and decomposed, and the frames table equals the JAX
package's build over the same masked clips. No test touches a network.
"""

import os
import shutil
import urllib.error

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from conftest import REPO_ROOT

from ab_line_classifier_tpu import config as jax_config
from ab_line_classifier_tpu.data import ab_line_dataset_creator as jax_ab
from ab_line_classifier_tpu.data import real_time as jax_rt
from ab_line_classifier_tpu.data.synthetic import (
    generate_dataset as jax_generate_dataset)
from ab_line_classifier_torch import config as torch_config
from ab_line_classifier_torch.data import ab_line_dataset_creator as torch_ab
from ab_line_classifier_torch.data import real_time as torch_rt
from ab_line_classifier_torch.data.synthetic import generate_dataset
from ab_line_classifier_torch.models.unet import seeded_unet_state
from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
from ab_line_classifier_torch.utils.tables import write_table

cv2 = pytest.importorskip("cv2")

# A query result covering every branch of the labelling: homogeneous clips,
# non-A/non-B, unlabelled, each B-line severity, an unknown label.
QUERY_ROWS = [
    ("p1", "a_lines", 10, "s3://c/10", ""),
    ("p1", "b_lines_<_3", 11, "s3://c/11", ""),
    ("p2", "b_lines-_moderate_(<50%_pleural_line)", 12, "s3://c/12", ""),
    ("p2", "b_lines-_severe_(>50%_pleural_line)", 13, "s3://c/13", ""),
    ("p3", "non_a_non_b", 14, "s3://c/14", ""),
    ("p3", "", 15, "s3://c/15", ""),
    ("p4", "a_lines", 16, "s3://c/16", "homogeneous"),
    ("p4", "b_lines_severe_50_pleural_line", 17, "s3://c/17", ""),
    ("p5", "mystery_label", 18, "s3://c/18", ""),
]
QUERY_COLUMNS = ("patient_id", "a_or_b_lines", "id", "s3_path",
                 "frame_homogeneity")


def configs(**paths):
    """(JAX Config, port Config) of config.yml with ``paths`` in PATHS."""
    with open(os.path.join(REPO_ROOT, "config.yml")) as f:
        d = yaml.safe_load(f)
    d["PATHS"].update(paths)
    return jax_config.Config(d), torch_config.Config(d)


def write_query_csv(path, rows=QUERY_ROWS):
    pd.DataFrame(rows, columns=QUERY_COLUMNS).replace("", np.nan).to_csv(
        path, index=False)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def write_mp4(path, n_frames, hw=(48, 64), seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = hw
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    rng = np.random.RandomState(seed)
    for _ in range(n_frames):
        vw.write(rng.randint(0, 256, (h, w, 3), np.uint8))
    vw.release()


def test_generate_dataset_equal_to_jax(tmp_path):
    kw = dict(n_patients=3, clips_per_patient=2, frames_per_clip=2,
              hw=(32, 32), seed=5)
    want = jax_generate_dataset(str(tmp_path / "jax"), **kw)
    got = generate_dataset(str(tmp_path / "torch"), **kw)
    for a, b in zip(want[:2], got[:2]):
        assert read_bytes(a) == read_bytes(b)
    names = sorted(os.listdir(want[2]))
    assert names == sorted(os.listdir(got[2])) and len(names) == 12
    for name in names:
        assert read_bytes(os.path.join(want[2], name)) == read_bytes(
            os.path.join(got[2], name))


class _PullOnly:
    """A creator of ``base`` that only pulls."""

    @staticmethod
    def of(base):
        class Creator(base):
            def query_to_df(self):
                pass

            def build_dataset(self):
                pass
        return Creator


def test_database_pull_counts_url_errors_and_removes_parts(tmp_path):
    clips = tmp_path / "clips.csv"
    pd.DataFrame({"id": [10, 11, 12], "s3_path": ["u/a", "u/b", "u/c"],
                  "patient_id": ["p", "q", "r"], "class": [0, 1, 1]}
                 ).to_csv(clips, index=False)
    fetched = []

    def flaky_fetch(url, out):
        fetched.append((url, os.path.basename(out)))
        with open(out, "wb") as f:
            f.write(url.encode())
        if url != "u/b":
            raise urllib.error.ContentTooShortError("reset mid-body", b"")

    raw = {}
    for pkg, base in (("jax", jax_ab.ABLineDatasetCreator),
                      ("torch", torch_ab.ABLineDatasetCreator)):
        raw[pkg] = str(tmp_path / pkg)
        jcfg, tcfg = configs(CLIPS_TABLE=str(clips), RAW_CLIPS=raw[pkg])
        kw = {"device": "cpu"} if pkg == "torch" else {}
        counts = _PullOnly.of(base)(jcfg if pkg == "jax" else tcfg,
                                    fetch_fn=flaky_fetch, **kw
                                    ).database_pull()
    assert counts == {"<urlopen error reset mid-body>": 2}
    assert fetched[3:] == fetched[:3] == [
        ("u/a", "10.mp4.part"), ("u/b", "11.mp4.part"),
        ("u/c", "12.mp4.part")]
    assert os.listdir(raw["torch"]) == os.listdir(raw["jax"]) == ["11.mp4"]
    assert read_bytes(os.path.join(raw["torch"], "11.mp4")) == b"u/b"


def test_creator_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_ab.ABLineDatasetCreator(tcfg)


def test_label_query_results_equal_to_jax(tmp_path):
    query = str(tmp_path / "query.csv")
    write_query_csv(query)
    want, got = str(tmp_path / "jax.csv"), str(tmp_path / "torch.csv")
    jax_ab.ABLineDatasetCreator.label_query_results(
        pd.read_csv(query)).to_csv(want, index=False)
    from ab_line_classifier_torch.utils.tables import read_table
    write_table(got, torch_ab.ABLineDatasetCreator.label_query_results(
        read_table(query)))
    assert read_bytes(got) == read_bytes(want)
    assert pd.read_csv(got)["class"].tolist() == [0, 1, 1, 1, 1, -1]


def test_query_to_df_with_an_injected_query_equal_to_jax(tmp_path):
    """The port's injected query and the JAX package's local query table
    give the same clips table."""
    sql = tmp_path / "query.sql"
    sql.write_text("SELECT * FROM clips;")
    local = str(tmp_path / "local_query.csv")
    write_query_csv(local)
    jcfg, _ = configs(QUERY_TABLE=local,
                      CLIPS_TABLE=str(tmp_path / "jax_clips.csv"))
    _, tcfg = configs(QUERY_TABLE=str(tmp_path / "torch_query.csv"),
                      DATABASE_QUERY=str(sql),
                      CLIPS_TABLE=str(tmp_path / "torch_clips.csv"))
    seen = []

    def query(text):
        seen.append(text)
        return [{k: (None if v == "" else v)
                 for k, v in zip(QUERY_COLUMNS, row)} for row in QUERY_ROWS]

    jax_ab.ABLineDatasetCreator(jcfg).query_to_df()
    table = torch_ab.ABLineDatasetCreator(tcfg, query_fn=query,
                                          device="cpu").query_to_df()
    assert seen == ["SELECT * FROM clips;"]
    assert read_bytes(tmp_path / "torch_clips.csv") == read_bytes(
        tmp_path / "jax_clips.csv")
    assert list(table) == ["patient_id", "a_or_b_lines", "id", "class",
                           "s3_path"]


def rt_workspace(tmp_path, with_mp4=False):
    """Annotations (a duplicate id, an annotation without a recording) and
    recordings (one without an annotation, a ``mask.jpg``) in the WaveBase
    layout ``<root>/<date>/masked_recordings/<id>/<id>.mp4``."""
    annot = tmp_path / "annot.csv"
    pd.DataFrame({"filename": [333, 111, 222, 111, 444],
                  "a_or_b_lines": ["b_lines_3", "a_lines",
                                   "b_lines_severe_50_pleural_line",
                                   "non_a_non_b", "b_lines_3"]}).to_csv(
        annot, index=False)
    root = tmp_path / "prospective"
    for date, clip_id in (("2024-01-01", 111), ("2024-01-01", 222),
                          ("2024-02-03", 333), ("2024-02-03", 555)):
        d = root / date / "masked_recordings" / str(clip_id)
        d.mkdir(parents=True)
        (d / "mask.jpg").write_bytes(b"")
        mp4 = str(d / f"{clip_id}.mp4")
        if with_mp4:
            write_mp4(mp4, n_frames=2, seed=clip_id)
        else:
            open(mp4, "wb").close()
    return str(annot), str(root) + "/"


@pytest.mark.parametrize("b_lines_3_class", ["b_lines", "a_lines"])
def test_rt_clips_table_equal_to_jax(tmp_path, b_lines_3_class):
    annot, root = rt_workspace(tmp_path)
    jcfg, tcfg = configs(RT_ROOT_DIR=root, RT_LABELBOX_ANNOTATIONS=annot)
    want, got = str(tmp_path / "jax.csv"), str(tmp_path / "torch.csv")
    jax_rt.create_rt_ABline_dataframe(
        jcfg, b_lines_3_class=b_lines_3_class, preprocessed=True).to_csv(
        want, index=False)
    write_table(got, torch_rt.create_rt_ABline_dataframe(
        tcfg, b_lines_3_class=b_lines_3_class, preprocessed=True))
    assert read_bytes(got) == read_bytes(want)
    assert torch_rt._rt_label_to_class("b_lines_3", b_lines_3_class) == (
        jax_rt._rt_label_to_class("b_lines_3", b_lines_3_class))


def test_rt_frames_table_equal_to_jax(tmp_path):
    """Every annotated clip has a recording here: the JAX package's build
    indexes the class list with the class column, which the outer merge
    makes float where a recording has no annotation."""
    annot, root = rt_workspace(tmp_path, with_mp4=True)
    pd.DataFrame({"filename": [111, 222, 333, 555],
                  "a_or_b_lines": ["a_lines", "b_lines_3", "b_lines_3",
                                   "non_a_non_b"]}).to_csv(annot, index=False)
    out = {}
    for pkg, rt in (("jax", jax_rt), ("torch", torch_rt)):
        jcfg, tcfg = configs(
            RT_ROOT_DIR=root, RT_LABELBOX_ANNOTATIONS=annot,
            FRAMES=str(tmp_path / pkg / "frames"),
            FRAME_TABLE=str(tmp_path / pkg / "frames.csv"))
        cfg = jcfg if pkg == "jax" else tcfg
        clips = str(tmp_path / f"{pkg}_clips.csv")
        table = rt.create_rt_ABline_dataframe(cfg, preprocessed=True)
        if pkg == "jax":
            table.to_csv(clips, index=False)
        else:
            write_table(clips, table)
        rt.create_rt_image_dataset(cfg, clips)
        out[pkg] = tmp_path / pkg
    assert read_bytes(out["torch"] / "frames.csv") == read_bytes(
        out["jax"] / "frames.csv")
    names = sorted(os.listdir(out["jax"] / "frames"))
    assert names == sorted(os.listdir(out["torch"] / "frames"))
    assert len(names) == 8
    for name in names:
        np.testing.assert_array_equal(
            cv2.imread(str(out["torch"] / "frames" / name)),
            cv2.imread(str(out["jax"] / "frames" / name)))


def test_creator_masks_and_builds_frames_on_the_cpu(tmp_path):
    """query (injected) -> pull (a local copy) -> auto-mask (a seeded
    U-Net on the CPU) -> build: every clip masked to
    ``<id>/<id>.mp4`` with its ``mask.jpg``, and the frames table equal
    to the JAX package's build over the same masked clips."""
    src = tmp_path / "bucket"
    for clip_id, n in ((10, 4), (11, 3), (16, 2)):
        write_mp4(str(src / f"{clip_id}.mp4"), n_frames=n, hw=(96, 128),
                  seed=clip_id)
    unet = torch_ckpt.save_model(str(tmp_path / "unet"),
                                 seeded_unet_state(8, 2),
                                 {"model_name": "unet", "base_filters": 8})
    sql = tmp_path / "query.sql"
    sql.write_text("SELECT * FROM clips;")
    paths = dict(DATABASE_QUERY=str(sql),
                 QUERY_TABLE=str(tmp_path / "query.csv"),
                 CLIPS_TABLE=str(tmp_path / "clips.csv"),
                 RAW_CLIPS=str(tmp_path / "raw"),
                 MASKED_CLIPS=str(tmp_path / "masked"),
                 AUTOMASK_MODEL_PATH=unet,
                 FRAMES=str(tmp_path / "frames"),
                 FRAME_TABLE=str(tmp_path / "frames.csv"))
    jcfg, tcfg = configs(**paths)
    rows = [dict(zip(QUERY_COLUMNS, r)) for r in QUERY_ROWS]
    for r in rows:
        r["s3_path"] = str(src / f"{r['id']}.mp4")
    pulled = []

    def fetch(url, out):
        if not os.path.exists(url):
            raise urllib.error.URLError(f"no object {url}")
        pulled.append(url)
        shutil.copyfile(url, out)

    creator = torch_ab.ABLineDatasetCreator(
        tcfg, query_fn=lambda sql: rows, fetch_fn=fetch, device="cpu")
    creator.create_dataset()
    # Labelled clips 10, 11, 12, 13, 17, 18; of those only 10 and 11 exist.
    assert sorted(os.path.basename(p) for p in pulled) == [
        "10.mp4", "11.mp4"]
    for clip_id, n in ((10, 4), (11, 3)):
        d = tmp_path / "masked" / str(clip_id)
        assert sorted(os.listdir(d)) == [f"{clip_id}.mp4", "mask.jpg"]
        cap = cv2.VideoCapture(str(d / f"{clip_id}.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
        cap.release()
    got = pd.read_csv(tmp_path / "frames.csv")
    assert list(got.columns) == ["Frame Path", "patient_id", "Class",
                                 "Class Name", "id"]
    assert got["Frame Path"].tolist() == [f"10_{i}.jpg" for i in range(4)] \
        + [f"11_{i}.jpg" for i in range(3)]

    jcfg, _ = configs(**dict(paths, FRAMES=str(tmp_path / "jax_frames"),
                             FRAME_TABLE=str(tmp_path / "jax_frames.csv")))
    jax_ab.ABLineDatasetCreator(jcfg).build_dataset()
    assert read_bytes(tmp_path / "frames.csv") == read_bytes(
        tmp_path / "jax_frames.csv")


def test_rt_frames_table_with_an_unmatched_clip_raises_as_jax(tmp_path):
    """A recording without an annotation (or the reverse) leaves a missing
    class after the outer merge, so the class column is float and both
    packages' builds raise on indexing the class list with it."""
    annot, root = rt_workspace(tmp_path, with_mp4=True)
    for pkg, rt in (("jax", jax_rt), ("torch", torch_rt)):
        jcfg, tcfg = configs(
            RT_ROOT_DIR=root, RT_LABELBOX_ANNOTATIONS=annot,
            FRAMES=str(tmp_path / pkg / "frames"),
            FRAME_TABLE=str(tmp_path / pkg / "frames.csv"))
        cfg = jcfg if pkg == "jax" else tcfg
        clips = str(tmp_path / f"{pkg}_clips.csv")
        table = rt.create_rt_ABline_dataframe(cfg, preprocessed=True)
        if pkg == "jax":
            table.to_csv(clips, index=False)
        else:
            write_table(clips, table)
        with pytest.raises(TypeError, match="list indices must be integers"):
            rt.create_rt_image_dataset(cfg, clips)
