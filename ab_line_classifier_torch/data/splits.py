"""Patient-grouped stratified splits (the part of the JAX package's
``data/splits.py`` that training's on-the-fly split needs).

Frames of one patient never straddle a split boundary. The primitive is
sklearn's ``StratifiedGroupKFold`` keyed on ``patient_id``, as in the JAX
package, so identical seeds give identical splits. sklearn is imported
only when a split runs.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

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
