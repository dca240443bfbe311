"""A/B-line dataset creator (port of the JAX package's
``data/ab_line_dataset_creator.py``).

Concrete :class:`DatasetCreator`: SQL query -> labelled clips table
(multi-severity B-line labels collapsed to class 1) -> clip pull ->
auto-mask -> frame decomposition -> frames table with the columns ``Frame
Path, patient_id, Class, Class Name, id``.

Tables are read and written without pandas (``utils/tables.py``: the
typing of ``pd.read_csv`` and the bytes of ``DataFrame.to_csv``). The
query is injectable: ``query_fn(sql) -> rows`` (a list of dicts), by
default a MySQL query with the creator's ``database_cfg``
(``mysql.connector`` is imported only there); without either, an existing
``PATHS.QUERY_TABLE`` CSV is the query's result. cv2 is imported only
where clips are decomposed (``data/video.py``).

    python -m ab_line_classifier_torch.data.ab_line_dataset_creator \\
        [--config config.yml] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import logging
import math
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ab_line_classifier_torch.data.dataset_creator import DatasetCreator
from ab_line_classifier_torch.data.video import mp4_to_frames
from ab_line_classifier_torch.utils.tables import (Table, read_table,
                                                   write_csv, write_table)

logging.basicConfig(format="[%(levelname)s] %(message)s", level=logging.INFO)

# Reference label -> class mapping (ab_line_dataset_creator.py:118-127).
LABEL_TO_CLASS_MAP = {
    "a_lines": 0,
    "b_lines_<_3": 1,
    "b_lines-_moderate_(<50%_pleural_line)": 1,
    "b_lines-_severe_(>50%_pleural_line)": 1,
    "b_lines_moderate_50_pleural_line": 1,
    "b_lines_3": 1,
    "b_lines_severe_50_pleural_line": 1,
    "non_a_non_b": 2,
}

B_LINE_RELABEL = {
    "b_lines_<_3": "b_lines",
    "b_lines-_moderate_(<50%_pleural_line)": "b_lines",
    "b_lines-_severe_(>50%_pleural_line)": "b_lines",
}

QueryFn = Callable[[str], Sequence[Dict]]


def is_null(v) -> bool:
    """``pd.isnull`` of one cell: None or a float NaN."""
    return v is None or (isinstance(v, (float, np.floating))
                         and math.isnan(v))


def mysql_query(database_cfg: Dict) -> QueryFn:
    """``sql -> rows`` against the MySQL database of ``database_cfg``
    (``USERNAME``, ``PASSWORD``, ``HOST``, ``DATABASE``)."""
    def run(sql: str) -> List[Dict]:
        import mysql.connector

        conn = mysql.connector.connect(
            user=database_cfg["USERNAME"], password=database_cfg["PASSWORD"],
            host=database_cfg["HOST"], database=database_cfg["DATABASE"])
        if not conn.is_connected():
            raise ConnectionError("Couldn't connect to database")
        logging.info("Connected to database")
        try:
            cursor = conn.cursor()
            cursor.execute(sql)
            names = [d[0] for d in cursor.description]
            return [dict(zip(names, row)) for row in cursor.fetchall()]
        finally:
            conn.close()
    return run


class ABLineDatasetCreator(DatasetCreator):
    """Reference ``ABLineDatasetCreator`` (ab_line_dataset_creator.py:
    17-147), on ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg, database_cfg: Optional[dict] = None,
                 query_fn: Optional[QueryFn] = None, **kw):
        super().__init__(cfg, **kw)
        self.database_cfg = database_cfg
        self.query_fn = query_fn or (mysql_query(database_cfg)
                                     if database_cfg else None)

    def mp4_to_images(self, mp4_path: str) -> List[str]:
        """Decompose a masked clip into ``{clip}_{idx}.jpg`` frames
        (reference :27-53)."""
        return mp4_to_frames(self.cfg["PATHS"]["FRAMES"], mp4_path)

    def build_dataset(self) -> None:
        """The frames table (reference :55-77): every frame of each clip's
        masked mp4 (``MASKED_CLIPS/<id>/<id>.mp4``), in clips-table
        order. A clips table none of whose clips has a masked mp4 raises,
        as the JAX package's ``pd.concat`` of no tables does."""
        clips = read_table(self.cfg["PATHS"]["CLIPS_TABLE"])
        masked_root = self.cfg["PATHS"]["MASKED_CLIPS"]
        classes = self.cfg["DATA"]["CLASSES"]
        rows = []
        for i in range(len(clips["id"])):
            clip_id, label = clips["id"][i], clips["class"][i]
            pattern = os.path.join(masked_root, str(clip_id), f"{clip_id}.mp4")
            for mp4_file in glob.glob(pattern):
                rows += [{"Frame Path": path,
                          "patient_id": clips["patient_id"][i],
                          "Class": label, "Class Name": classes[label],
                          "id": clip_id}
                         for path in self.mp4_to_images(mp4_file)]
        if not rows:
            raise ValueError(f"no masked clips of the clips table under "
                             f"{masked_root!r}: nothing to build")
        write_csv(self.cfg["PATHS"]["FRAME_TABLE"], rows)

    @staticmethod
    def label_query_results(table: Table) -> Table:
        """The filtering and labelling of ``query_to_df`` (reference
        :109-142): drop homogeneous ('muggle') clips, non-A/non-B and
        unlabelled rows, map labels to classes, collapse the B-line
        severities; the columns ``patient_id, a_or_b_lines, id, class,
        s3_path``."""
        labels = table["a_or_b_lines"]
        keep = np.array([is_null(h) and not is_null(a) and a != "non_a_non_b"
                         for h, a in zip(table["frame_homogeneity"], labels)],
                        bool)
        kept = labels[keep]
        out = {k: table[k][keep] for k in ("patient_id", "a_or_b_lines",
                                           "id")}
        out["class"] = np.array([LABEL_TO_CLASS_MAP.get(v, -1) for v in kept],
                                np.int64)
        relabelled = np.empty(len(kept), object)
        relabelled[:] = [B_LINE_RELABEL.get(v, v) for v in kept]
        out["a_or_b_lines"] = relabelled
        out["s3_path"] = table["s3_path"][keep]
        return out

    def query_to_df(self) -> Table:
        """Query -> the labelled clips table, written to
        ``PATHS.CLIPS_TABLE`` (reference :79-147). With a query (injected,
        or MySQL from ``database_cfg``) its rows are first written to
        ``PATHS.QUERY_TABLE`` and read back typed as ``pd.read_csv`` types
        them; without one, an existing ``QUERY_TABLE`` is the result."""
        query_table = self.cfg["PATHS"]["QUERY_TABLE"]
        if self.query_fn is not None:
            with open(self.cfg["PATHS"]["DATABASE_QUERY"]) as f:
                rows = self.query_fn(f.read())
            write_csv(query_table, rows)
        elif not os.path.isfile(query_table):
            raise FileNotFoundError(
                f"no database config, no query and no local query table at "
                f"{query_table!r}")
        else:
            logging.info("Using local query table %s", query_table)
        table = self.label_query_results(read_table(query_table))
        write_table(self.cfg["PATHS"]["CLIPS_TABLE"], table)
        return table


def main(argv=None) -> int:
    """Create the A/B-line dataset of ``config.yml`` (``database_config.yml``
    in the working directory gives the MySQL credentials; without it the
    local query table is used)."""
    from ab_line_classifier_torch.config import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    database_cfg = None
    db_path = os.path.join(os.getcwd(), "database_config.yml")
    if os.path.isfile(db_path):
        import yaml

        with open(db_path) as f:
            database_cfg = yaml.safe_load(f)
    ABLineDatasetCreator(cfg, database_cfg,
                         device=args.device).create_dataset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
