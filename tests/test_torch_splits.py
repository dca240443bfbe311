"""PyTorch port, splits: ``k_fold_splits``, ``fold_train_val_test`` (index
labels too), ``partition_dataset``, ``generate_clips_table_subset`` and
``leakage_check`` equal the JAX package's on synthetic frame tables with
patient ids, exactly (``pd.testing.assert_frame_equal``); and the array
form of a fold set (``FoldSet``) equals the tables it came from.
"""

import numpy as np
import pandas as pd
import pytest

from ab_line_classifier_tpu.data import splits as J
from ab_line_classifier_torch.data import splits as S


def frames_df(n_patients=24, seed=0):
    """Frames of ``n_patients`` patients, 2-9 frames each, classes skewed
    per patient, in a shuffled row order."""
    rng = np.random.RandomState(seed)
    rows = []
    for p in range(n_patients):
        label = int(rng.rand() < 0.4)
        for f in range(rng.randint(2, 10)):
            rows.append({"Frame Path": f"clip{p:03d}_{f}.jpg",
                         "patient_id": f"pat{p:03d}", "Class": label,
                         "id": p})
    df = pd.DataFrame(rows)
    return df.iloc[rng.permutation(len(df))].reset_index(drop=True)


@pytest.mark.parametrize("n_folds,seed", [(3, 42), (5, 7), (4, 10001)])
def test_k_fold_splits_and_folds_match_jax(n_folds, seed):
    df = frames_df(seed=seed)
    want = J.k_fold_splits(df, n_folds, random_seed=seed)
    got = S.k_fold_splits(df, n_folds, random_seed=seed)
    assert len(got) == len(want) == n_folds
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)
    for fold_id in range(n_folds):
        for g, w in zip(S.fold_train_val_test(got, fold_id, 0.2, seed),
                        J.fold_train_val_test(want, fold_id, 0.2, seed)):
            pd.testing.assert_frame_equal(g, w)  # index labels included
        assert S.leakage_check(*S.fold_train_val_test(got, fold_id, 0.2,
                                                      seed))


@pytest.mark.parametrize("seed", [0, 3])
def test_train_val_test_and_partition_match_jax(tmp_path, seed):
    df = frames_df(n_patients=30, seed=seed)
    for g, w in zip(S.train_val_test_split(df, 0.1, 0.2, random_seed=seed),
                    J.train_val_test_split(df, 0.1, 0.2, random_seed=seed)):
        pd.testing.assert_frame_equal(g, w)
    got = S.partition_dataset(df, 0.2, 0.2, str(tmp_path / "port"),
                              random_seed=seed)
    want = J.partition_dataset(df, 0.2, 0.2, str(tmp_path / "jax"),
                               random_seed=seed)
    for g, w, name in zip(got, want, ("train_set", "val_set", "test_set")):
        pd.testing.assert_frame_equal(g, w)
        assert (tmp_path / "port" / f"{name}.csv").read_bytes() == (
            tmp_path / "jax" / f"{name}.csv").read_bytes()
    with pytest.raises(ValueError, match="partitions_dir"):
        S.partition_dataset(df, 0.2, 0.2, None)


def test_clips_subset_and_leakage_check_match_jax():
    df = frames_df()
    clips = pd.DataFrame({"id": range(30),
                          "filename": [f"c{i}" for i in range(30)]})
    sub = df[df["id"] % 3 == 0]
    pd.testing.assert_frame_equal(S.generate_clips_table_subset(clips, sub),
                                  J.generate_clips_table_subset(clips, sub))
    a, b = df[df["id"] < 10], df[df["id"] >= 10]
    overlapping = df[df["id"] >= 8]
    for tables in ((a, b), (a, overlapping), (a, b, a.iloc[:1])):
        assert S.leakage_check(*tables) == J.leakage_check(*tables)
    assert S.leakage_check(a, b) and not S.leakage_check(a, overlapping)


@pytest.mark.parametrize("from_csv", [False, True])
def test_fold_set_equals_its_tables(tmp_path, from_csv):
    """The array form: fold tables (from ``k_fold_splits``, or read back
    from CSVs, whose index labels restart at 0 in every fold) -> one table
    and, per fold, train/val/test rows that select exactly the rows, in
    the order, of the JAX package's ``fold_train_val_test``."""
    df = frames_df()
    folds = J.k_fold_splits(df, 3, random_seed=42)
    if from_csv:
        for i, f in enumerate(folds):
            f.to_csv(tmp_path / f"fold_{i}.csv", index=False)
        folds = [pd.read_csv(tmp_path / f"fold_{i}.csv") for i in range(3)]
    table, fold_set = S.fold_set_from_tables(folds, 0.25, random_seed=42)
    assert len(fold_set) == 3 and len(table) == len(df)
    assert list(table.index) == list(range(len(df)))
    for fold_id in range(3):
        want = J.fold_train_val_test(folds, fold_id, 0.25, random_seed=42)
        for rows, w in zip(fold_set.fold(fold_id), want):
            assert rows.dtype == np.int64
            pd.testing.assert_frame_equal(
                table.iloc[rows].reset_index(drop=True),
                w.reset_index(drop=True))
    with pytest.raises(ValueError, match="out of range"):
        fold_set.fold(3)


def test_split_fold_set_equals_its_tables():
    df = frames_df(n_patients=30)
    parts = J.train_val_test_split(df, 0.1, 0.2, random_seed=5)
    table, fold_set = S.fold_set_from_split(*parts)
    assert len(fold_set) == 1
    for rows, w in zip(fold_set.fold(0), parts):
        pd.testing.assert_frame_equal(table.iloc[rows].reset_index(drop=True),
                                      w.reset_index(drop=True))
