"""Patient-grouped stratified splits (port of the JAX package's
``data/splits.py``), and the array form of a fold set.

Frames of one patient never straddle a split boundary. The primitive is
sklearn's ``StratifiedGroupKFold`` keyed on ``patient_id``, as in the JAX
package, so identical seeds give identical splits. pandas and sklearn are
imported by the functions that split tables, never at import.

Topology (JAX ``data/splits.py:1-18``):

* TrainValTest: the test split first, then a relative val split of the
  rest (``val_split / (1 - test_split)``).
* KFoldCrossValidation: k grouped stratified folds; at training time fold
  i is the test set and the val set a grouped split of the other folds.

:class:`FoldSet` is a fold set as row indices into one frame table: per
fold, the train, val and test rows. It is what cross-validation and
hyperparameter search train from (``train/experiment.py``), and the seam
through which they run where pandas and sklearn are not installed.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

FRAME_PATH = "Frame Path"
CLASS = "Class"
PATIENT_ID = "patient_id"


def group_train_test_split(data_df, test_size: float,
                           group_key: str = PATIENT_ID,
                           target_key: str = CLASS, random_seed: int = 42
                           ) -> Tuple:
    """Grouped stratified two-way split: ``floor(1 / test_size)`` folds,
    the first fold's rows the test set."""
    from sklearn.model_selection import StratifiedGroupKFold

    sgkf = StratifiedGroupKFold(n_splits=math.floor(1.0 / test_size),
                                shuffle=True, random_state=random_seed)
    train_index, test_index = next(sgkf.split(
        data_df, data_df[target_key].values,
        groups=np.asarray(data_df[group_key].values)))
    return data_df.iloc[train_index], data_df.iloc[test_index]


def train_val_test_split(frames_df, val_split: float, test_split: float,
                         random_seed: int = 42) -> Tuple:
    """TrainValTest: the test split first, then the relative val split
    (``val_split / (1 - test_split)``) of the rest."""
    train_val_df, test_df = group_train_test_split(
        frames_df, test_split, random_seed=random_seed)
    train_df, val_df = group_train_test_split(
        train_val_df, val_split / (1.0 - test_split), random_seed=random_seed)
    return train_df, val_df, test_df


def k_fold_splits(frames_df, n_folds: int, random_seed: int = 42) -> List:
    """The k fold frame tables (JAX ``data/splits.py:65-74``): fold i is
    the i-th ``StratifiedGroupKFold`` test subset."""
    from sklearn.model_selection import StratifiedGroupKFold

    sgkf = StratifiedGroupKFold(n_splits=n_folds, shuffle=True,
                                random_state=random_seed)
    return [frames_df.iloc[test_index] for _, test_index in sgkf.split(
        frames_df, frames_df[CLASS].values,
        groups=np.asarray(frames_df[PATIENT_ID].values))]


def fold_train_val_test(folds: Sequence, fold_id: int, val_split: float,
                        random_seed: int = 42) -> Tuple:
    """Fold ``fold_id``'s train, val and test tables (JAX
    ``data/splits.py:77-99``): test is fold ``fold_id``; train and val are
    a grouped split of the other folds, concatenated.

    Row index labels pass through unchanged (the split slices by
    position): for folds from :func:`k_fold_splits` of a frame table with
    a RangeIndex, ``train_df.index`` and the others are row positions in
    that table."""
    import pandas as pd

    rest = pd.concat([f for i, f in enumerate(folds) if i != fold_id])
    train_df, val_df = group_train_test_split(rest, val_split,
                                              random_seed=random_seed)
    return train_df, val_df, folds[fold_id]


def partition_dataset(frames_df, val_split: float, test_split: float,
                      partitions_dir: Optional[str] = None,
                      save_dfs: bool = True,
                      random_seed: Optional[int] = None) -> Tuple:
    """The legacy local partitioner (JAX ``data/splits.py:102-133``): a
    plain random split of the unique patient ids (grouped, not
    stratified), with the relative val split, written as ``train_set.csv``
    / ``val_set.csv`` / ``test_set.csv`` under ``partitions_dir`` when
    ``save_dfs``."""
    from sklearn.model_selection import train_test_split

    all_pts = np.asarray(frames_df[PATIENT_ID].unique())
    trainval_pts, test_pts = train_test_split(
        all_pts, test_size=test_split, random_state=random_seed)
    train_pts, val_pts = train_test_split(
        trainval_pts, test_size=val_split / (1.0 - test_split),
        random_state=random_seed)
    out = tuple(frames_df[frames_df[PATIENT_ID].isin(pts)]
                for pts in (train_pts, val_pts, test_pts))
    if save_dfs:
        if not partitions_dir:
            raise ValueError("save_dfs=True needs partitions_dir "
                             "(PATHS.PARTITIONS)")
        os.makedirs(partitions_dir, exist_ok=True)
        for name, df in zip(("train_set", "val_set", "test_set"), out):
            df.to_csv(os.path.join(partitions_dir, f"{name}.csv"))
    return out


def generate_clips_table_subset(clips_df, frames_df):
    """The clips whose ``id`` appears in a frames subset."""
    ids = frames_df["id"].unique() if "id" in frames_df.columns else []
    return clips_df[clips_df["id"].isin(ids)]


def leakage_check(*dfs, group_key: str = PATIENT_ID) -> bool:
    """True iff no group appears in more than one of the tables."""
    seen: set = set()
    for df in dfs:
        groups = set(df[group_key].unique())
        if groups & seen:
            return False
        seen |= groups
    return True


@dataclasses.dataclass
class FoldSet:
    """A fold set as row indices into one frame table: ``train[i]``,
    ``val[i]`` and ``test[i]`` are fold i's rows, int64, in the order its
    tables list them. A train/val/test split is a one-fold set."""

    train: List[np.ndarray]
    val: List[np.ndarray]
    test: List[np.ndarray]

    def __len__(self) -> int:
        return len(self.test)

    def fold(self, fold_id: int) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        if not 0 <= fold_id < len(self):
            raise ValueError(f"fold_id {fold_id} out of range: the fold set "
                             f"has {len(self)} folds")
        return self.train[fold_id], self.val[fold_id], self.test[fold_id]


def fold_set_from_tables(folds: Sequence, val_split: float,
                         random_seed: int = 42) -> Tuple:
    """``(table, fold_set)``: the fold tables concatenated into one frame
    table (a RangeIndex, fold 0's rows first), and for every fold the rows
    of that table that :func:`fold_train_val_test` gives it, in the same
    order."""
    import pandas as pd

    starts = np.cumsum([0] + [len(f) for f in folds])
    placed = [f.set_axis(pd.RangeIndex(a, b)) for f, a, b
              in zip(folds, starts[:-1], starts[1:])]
    parts = [fold_train_val_test(placed, i, val_split, random_seed)
             for i in range(len(placed))]
    rows = [[df.index.to_numpy(np.int64) for df in p] for p in parts]
    return pd.concat(placed), FoldSet(*map(list, zip(*rows)))


def fold_set_from_split(train_df, val_df, test_df) -> Tuple:
    """``(table, fold_set)`` of one train/val/test split: the three tables
    concatenated into one (a RangeIndex) and the one-fold set of their
    rows."""
    import pandas as pd

    table = pd.concat([train_df, val_df, test_df], ignore_index=True)
    a, b = len(train_df), len(train_df) + len(val_df)
    return table, FoldSet([np.arange(a, dtype=np.int64)],
                          [np.arange(a, b, dtype=np.int64)],
                          [np.arange(b, len(table), dtype=np.int64)])
