"""Prospective (real-time) dataset ingestion (port of the JAX package's
``data/real_time.py``).

Builds a frames dataset from WaveBase-device prospective recordings: walks
dated directories of masked clips, maps Labelbox expert annotations to
binary classes (with the configurable ``RT_B_LINES_3_CLASS`` for clips of
fewer than 3 B-lines), decomposes clips into frames and writes a frames
table without patient ids (real-time clips carry none).

Tables are :data:`utils.tables.Table` dicts, read and written without
pandas with ``pd.read_csv``'s typing and ``DataFrame.to_csv``'s bytes; the
annotations-to-paths join is pandas' outer merge (:func:`outer_merge`).
The Labelbox annotations are read as CSV: a raw Excel export needs pandas'
Excel reader, which the port does not carry, and raises. cv2 is imported
only where clips are decomposed (``data/video.py``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from ab_line_classifier_torch.data.ab_line_dataset_creator import is_null
from ab_line_classifier_torch.data.video import mp4_to_frames
from ab_line_classifier_torch.utils.tables import (Table, read_table,
                                                   write_csv)


def get_rt_masked_clip_paths(cfg) -> Table:
    """``filename`` (int) and ``Path`` of every prospective masked clip
    (reference real_time.py:13-36). Files whose stem is not a clip id (the
    ``mask.jpg`` auto-masking writes beside each clip) are skipped."""
    rootdir = cfg["PATHS"]["RT_ROOT_DIR"]
    clips_dir = "masked_recordings"
    ids: List[int] = []
    paths: List[str] = []
    dated_dirs = next(os.walk(rootdir))[1] if os.path.isdir(rootdir) else []
    for dated_dir in dated_dirs:
        for _, _, files in os.walk(os.path.join(rootdir, dated_dir,
                                                clips_dir)):
            for clip in files:
                clip_id = clip.split(".")[0]
                if not clip_id.isdigit():
                    continue
                ids.append(int(clip_id))
                paths.append(os.path.join(rootdir, dated_dir, clips_dir,
                                          clip_id))
    path_col = np.empty(len(paths), object)
    path_col[:] = paths
    return {"filename": np.array(ids, np.int64), "Path": path_col}


def _rt_label_to_class(label, b_lines_3_class: str) -> int:
    """The reference's nested-conditional mapping (real_time.py:62-67)."""
    b_lines_3_dict = {"b_lines": 1, "a_lines": 0}
    if label == "a_lines":
        return 0
    if label == "b_lines_3":
        return b_lines_3_dict[b_lines_3_class]
    if label in ("b_lines_moderate_50_pleural_line",
                 "b_lines_severe_50_pleural_line"):
        return 1
    if label == "non_a_non_b":
        return 0
    return -1


def _with_missing(col: np.ndarray, n_missing: int) -> np.ndarray:
    """``col`` extended by ``n_missing`` missing cells as pandas extends
    it: an integer column becomes float64 with NaN; other columns take
    NaN (float) or None (object)."""
    if n_missing == 0:
        return col
    if col.dtype.kind in "iuf":
        return np.concatenate([col.astype(np.float64),
                               np.full(n_missing, np.nan)])
    return np.concatenate([col.astype(object),
                           np.full(n_missing, None, object)])


def outer_merge(left: Table, right: Table, on: str) -> Table:
    """``pd.merge(left, right, how="outer", on=on)``: the union of the
    keys, sorted; for each key every left row with it paired with every
    right row with it, each side in its own order; a side without the key
    gives missing cells (an integer column becoming float64). Columns:
    ``on``, the left's others, then the right's."""
    lkeys, rkeys = list(left[on]), list(right[on])
    rows = []  # (left index or None, right index or None, key)
    for key in sorted(set(lkeys) | set(rkeys)):
        li = [i for i, k in enumerate(lkeys) if k == key] or [None]
        ri = [j for j, k in enumerate(rkeys) if k == key] or [None]
        rows += [(i, j, key) for i in li for j in ri]

    def take(table: Table, side: int) -> Dict[str, np.ndarray]:
        present = [r[side] for r in rows if r[side] is not None]
        n_missing = len(rows) - len(present)
        # Rows with the side missing carry the cells at the end; put each
        # row's cell in its place.
        order = np.argsort([r[side] is None for r in rows], kind="stable")
        out = {}
        for name, col in table.items():
            if name == on:
                continue
            full = _with_missing(col[np.array(present, np.int64)], n_missing)
            placed = np.empty_like(full)
            placed[order] = full
            out[name] = placed
        return out

    keys = np.array([r[2] for r in rows])
    if keys.dtype.kind not in "iuf":
        keys = keys.astype(object)
    return {on: keys, **take(left, 0), **take(right, 1)}


def create_rt_ABline_dataframe(cfg, lb_annot: Optional[str] = None,
                               b_lines_3_class: Optional[str] = None,
                               preprocessed: bool = False) -> Table:
    """Labelbox annotations (a CSV with ``filename`` and ``a_or_b_lines``)
    -> the clips table, outer-joined with the masked clips' paths on
    ``filename`` (reference real_time.py:39-77). A raw Excel export
    (``preprocessed`` False and an ``.xlsx`` / ``.xls`` path) raises."""
    lb_annot = lb_annot or cfg["PATHS"]["RT_LABELBOX_ANNOTATIONS"]
    b_lines_3_class = b_lines_3_class or cfg["DATA"]["RT_B_LINES_3_CLASS"]
    if not preprocessed and lb_annot.endswith((".xlsx", ".xls")):
        raise NotImplementedError(
            f"{lb_annot!r}: the port reads Labelbox annotations as CSV "
            f"(filename, a_or_b_lines); export the sheet to CSV")
    table = dict(read_table(lb_annot))
    labels = table["a_or_b_lines"]
    table["class"] = np.array([_rt_label_to_class(v, b_lines_3_class)
                               for v in labels], np.int64)
    relabel = {"b_lines_3": b_lines_3_class,
               "b_lines_moderate_50_pleural_line": "b_lines",
               "b_lines_severe_50_pleural_line": "b_lines"}
    relabelled = np.empty(len(labels), object)
    relabelled[:] = [v if is_null(v) else relabel.get(v, v) for v in labels]
    table["a_or_b_lines"] = relabelled
    return outer_merge(table, get_rt_masked_clip_paths(cfg), "filename")


def mp4_to_images(cfg, mp4_path: str) -> List[str]:
    """Masked clip -> ``{clip}_{idx}.jpg`` frames (reference :79-105)."""
    return mp4_to_frames(cfg["PATHS"]["FRAMES"], mp4_path)


def create_rt_image_dataset(cfg, query_df_path: str) -> None:
    """The frames table of the real-time clips, with no ``patient_id``
    column (reference :108-127), written to ``PATHS.FRAME_TABLE``. A clips
    table none of whose clips has an mp4 raises, as the JAX package's
    ``pd.concat`` of no tables does."""
    clips = read_table(query_df_path)
    classes = cfg["DATA"]["CLASSES"]
    rows = []
    for i in range(len(clips["filename"])):
        label = clips["class"][i]
        pattern = os.path.join(str(clips["Path"][i]),
                               f"{clips['filename'][i]}.mp4")
        for mp4_file in glob.glob(pattern):
            rows += [{"Frame Path": path, "Class": label,
                      "Class Name": classes[label]}
                     for path in mp4_to_images(cfg, mp4_file)]
    if not rows:
        raise ValueError(f"no clips of {query_df_path!r} found: nothing to "
                         f"build")
    write_csv(cfg["PATHS"]["FRAME_TABLE"], rows)
