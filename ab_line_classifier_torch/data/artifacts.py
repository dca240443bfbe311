"""Versioned dataset artifact lineage in a local store (port of the JAX
package's ``data/artifacts.py``; the same layout on disk, so a store that
either package writes reads the same through the other).

The reference keeps its dataset lineage as W&B artifacts: ``Images``
(frames + tables) -> ``ModelDev`` + ``Holdout`` (patient-grouped 90/10) ->
``TrainValTest`` and ``KFoldCrossValidation``. Here that lineage lives
under a local root (default ``results/artifacts/``)::

    artifacts/
      Images/v0/            frames.csv  clips_table.csv  metadata.json
      ModelDev/v0/          frames.csv  clips_table.csv  metadata.json
      Holdout/v0/           ...
      TrainValTest/v0/      frames/{train,val,test}.csv clips/{...}.csv
      KFoldCrossValidation/v0/   fold_0/{frames,clips}.csv ... metadata.json

Each ``metadata.json`` records the upstream artifact version, seeds and
split fractions, and is written last (the commit marker). Versions count
up; ``latest`` resolves to the highest committed one. pandas is imported
by the functions that read or write tables, never at import.

Run ``python -m ab_line_classifier_torch.data.artifacts [--config C]`` to
log the stages that ``WANDB.LOGGING`` enables.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.data import splits as S

IMAGES = "Images"
MODEL_DEV = "ModelDev"
HOLDOUT = "Holdout"
TRAIN_VAL_TEST = "TrainValTest"
K_FOLD = "KFoldCrossValidation"


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root

    # -- plumbing ----------------------------------------------------------
    def _artifact_root(self, name: str) -> str:
        return os.path.join(self.root, name)

    def versions(self, name: str) -> List[str]:
        root = self._artifact_root(name)
        if not os.path.isdir(root):
            return []
        # metadata.json is the commit marker (every logger writes it LAST,
        # atomically): a version dir without one is a log that crashed
        # mid-write and must not resolve as "latest".
        vs = [d for d in os.listdir(root) if d.startswith("v")
              and d[1:].isdigit()
              and os.path.isfile(os.path.join(root, d, "metadata.json"))]
        return sorted(vs, key=lambda v: int(v[1:]))

    def resolve(self, name: str, version: str = "latest") -> str:
        vs = self.versions(name)
        if not vs:
            raise FileNotFoundError(f"no versions of artifact {name!r} under "
                                    f"{self.root!r}")
        v = vs[-1] if version in ("", "latest", None) else version
        path = os.path.join(self._artifact_root(name), v)
        # Explicitly pinned versions honor the same metadata.json commit
        # marker as "latest": a version dir whose log crashed mid-write
        # must not resolve just because the caller named it.
        if (not os.path.isdir(path)
                or not os.path.isfile(os.path.join(path, "metadata.json"))):
            raise FileNotFoundError(
                f"artifact {name}:{version} not found (or not committed)")
        return path

    def new_version_dir(self, name: str) -> str:
        vs = self.versions(name)
        nxt = f"v{int(vs[-1][1:]) + 1 if vs else 0}"
        path = os.path.join(self._artifact_root(name), nxt)
        if os.path.isdir(path):
            # By construction an uncommitted partial (committed versions are
            # listed above and skipped): clear its leftovers so the new log
            # can't inherit stale files (e.g. extra fold dirs).
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        return path

    def metadata(self, name: str, version: str = "latest") -> Dict:
        with open(os.path.join(self.resolve(name, version),
                               "metadata.json")) as f:
            return json.load(f)

    def _write_meta(self, path: str, meta: Dict) -> None:
        # Marker-last is only crash-consistent if the data it commits is
        # durable FIRST: fsync every staged file (and every directory, so
        # the entries themselves survive) before the marker rename, then
        # fsync the version dir to persist the rename. Without this, a
        # power loss can leave a committed metadata.json pointing at
        # empty/torn CSVs that versions()/resolve() would trust.
        for dirpath, _dirnames, filenames in os.walk(path):
            for fn in filenames:
                fd = os.open(os.path.join(dirpath, fn), os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        for dirpath, _dirnames, _filenames in os.walk(path, topdown=False):
            fd = os.open(dirpath, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        meta = dict(meta)
        meta["artifact_version"] = os.path.basename(path)
        tmp = os.path.join(path, "metadata.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, "metadata.json"))
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- lineage stages ----------------------------------------------------
    def log_images(self, frames_csv: str, clips_csv: str,
                   frames_dir: Optional[str] = None) -> str:
        """Stage 1 (reference artifact_logging.py:54-84): the raw frames +
        clips tables (frame files referenced by directory, not copied)."""
        path = self.new_version_dir(IMAGES)
        shutil.copy(frames_csv, os.path.join(path, "frames.csv"))
        shutil.copy(clips_csv, os.path.join(path, "clips_table.csv"))
        self._write_meta(path, {
            "type": "dataset", "frames_dir": os.path.abspath(frames_dir)
            if frames_dir else None})
        return path

    def log_model_dev_holdout(self, cfg: Config) -> Tuple[str, str]:
        """Stage 2 (reference artifact_logging.py:87-148): grouped split of
        Images into ModelDev and the never-touched Holdout."""
        import pandas as pd

        src = self.resolve(IMAGES)
        frames = pd.read_csv(os.path.join(src, "frames.csv"))
        clips = pd.read_csv(os.path.join(src, "clips_table.csv"))
        seed = int(cfg["WANDB"]["ARTIFACT_SEED"])
        holdout_split = float(cfg["DATA"]["HOLDOUT_ARTIFACT_SPLIT"])
        dev_frames, holdout_frames = S.group_train_test_split(
            frames, holdout_split, random_seed=seed)
        dev_clips = S.generate_clips_table_subset(clips, dev_frames)
        holdout_clips = S.generate_clips_table_subset(clips, holdout_frames)

        images_meta = self.metadata(IMAGES)
        out = []
        # Stage BOTH version dirs' data first, then commit the two metadata
        # markers back-to-back: ModelDev and Holdout only make sense as a
        # pair from ONE split run — a crash between a committed ModelDev
        # and its Holdout would pair the new ModelDev with a stale Holdout
        # from an older Images version, and patients could appear in both
        # (the leakage this lineage exists to prevent). Adjacent commits
        # shrink that window from seconds of CSV writing to microseconds;
        # the shared images_artifact_version field makes any residual
        # mismatch detectable.
        for name, fdf, cdf in ((MODEL_DEV, dev_frames, dev_clips),
                               (HOLDOUT, holdout_frames, holdout_clips)):
            path = self.new_version_dir(name)
            fdf.to_csv(os.path.join(path, "frames.csv"), index=False)
            cdf.to_csv(os.path.join(path, "clips_table.csv"), index=False)
            out.append(path)
        for path in out:
            self._write_meta(path, {
                "images_artifact_version": images_meta["artifact_version"],
                "random_seed": seed, "holdout_split": holdout_split,
                "frames_dir": images_meta.get("frames_dir")})
        return tuple(out)

    def log_train_val_test(self, cfg: Config) -> str:
        """Stage 3a (reference artifact_logging.py:186-263)."""
        import pandas as pd

        src = self.resolve(MODEL_DEV)
        frames = pd.read_csv(os.path.join(src, "frames.csv"))
        clips = pd.read_csv(os.path.join(src, "clips_table.csv"))
        seed = int(cfg["WANDB"]["ARTIFACT_SEED"])
        val_split = float(cfg["DATA"]["VAL_SPLIT"])
        test_split = float(cfg["DATA"]["TEST_SPLIT"])

        train_f, val_f, test_f = S.train_val_test_split(
            frames, val_split, test_split, random_seed=seed)

        path = self.new_version_dir(TRAIN_VAL_TEST)
        os.makedirs(os.path.join(path, "frames"), exist_ok=True)
        os.makedirs(os.path.join(path, "clips"), exist_ok=True)
        for split, fdf in (("train", train_f), ("val", val_f),
                           ("test", test_f)):
            fdf.to_csv(os.path.join(path, "frames", f"{split}.csv"),
                       index=False)
            S.generate_clips_table_subset(clips, fdf).to_csv(
                os.path.join(path, "clips", f"{split}.csv"), index=False)
        dev_meta = self.metadata(MODEL_DEV)
        self._write_meta(path, {
            "model_dev_artifact_version": dev_meta["artifact_version"],
            "random_seed": seed, "val_split": val_split,
            "test_split": test_split,
            "frames_dir": dev_meta.get("frames_dir")})
        return path

    def log_k_fold_cross_val(self, cfg: Config) -> str:
        """Stage 3b (reference artifact_logging.py:266-332)."""
        import pandas as pd

        src = self.resolve(MODEL_DEV)
        frames = pd.read_csv(os.path.join(src, "frames.csv"))
        clips = pd.read_csv(os.path.join(src, "clips_table.csv"))
        seed = int(cfg["WANDB"]["ARTIFACT_SEED"])
        n_folds = int(cfg["TRAIN"]["N_FOLDS"])

        path = self.new_version_dir(K_FOLD)
        for i, fold_df in enumerate(S.k_fold_splits(frames, n_folds,
                                                    random_seed=seed)):
            fold_path = os.path.join(path, f"fold_{i}")
            os.makedirs(fold_path, exist_ok=True)
            fold_df.to_csv(os.path.join(fold_path, "frames.csv"), index=False)
            S.generate_clips_table_subset(clips, fold_df).to_csv(
                os.path.join(fold_path, "clips.csv"), index=False)
        dev_meta = self.metadata(MODEL_DEV)
        self._write_meta(path, {
            "model_dev_artifact_version": dev_meta["artifact_version"],
            "n_folds": n_folds, "random_seed": seed,
            "val_split": float(cfg["DATA"]["K_FOLD_VALIDATION_SPLIT"]),
            "frames_dir": dev_meta.get("frames_dir")})
        return path

    # -- training-side fetchers (reference train_utils.py) -----------------
    def get_train_val_test_artifact(self, version: str = "latest"
                                    ) -> Tuple:
        """Reference ``get_train_val_test_artifact`` (train_utils.py:18-46):
        walks lineage to the frames dir + split tables."""
        import pandas as pd

        path = self.resolve(TRAIN_VAL_TEST, version)
        meta = self.metadata(TRAIN_VAL_TEST, version)
        read = lambda s: pd.read_csv(os.path.join(path, "frames", f"{s}.csv"))
        return (read("train"), read("val"), read("test"),
                meta.get("frames_dir"))

    def get_n_folds(self, version: str = "latest") -> int:
        """Reference ``get_n_folds`` (train_utils.py:162-190)."""
        return int(self.metadata(K_FOLD, version)["n_folds"])

    def get_fold_artifact(self, fold_id: int, version: str = "latest"
                          ) -> Tuple:
        """Reference ``get_fold_artifact`` (train_utils.py:192-235): test =
        fold k; train/val = grouped split of the remaining folds."""
        import pandas as pd

        path = self.resolve(K_FOLD, version)
        meta = self.metadata(K_FOLD, version)
        n_folds = int(meta["n_folds"])
        folds = [pd.read_csv(os.path.join(path, f"fold_{i}", "frames.csv"))
                 for i in range(n_folds)]
        train_df, val_df, test_df = S.fold_train_val_test(
            folds, fold_id, float(meta["val_split"]),
            random_seed=int(meta["random_seed"]))
        return train_df, val_df, test_df, meta.get("frames_dir")


def store_from_config(cfg: Config) -> ArtifactStore:
    root = cfg.get("TRACKER", {}).get("ARTIFACTS_DIR", "results/artifacts/") \
        if cfg.get("TRACKER") else "results/artifacts/"
    return ArtifactStore(root)


def log_all(cfg: Config) -> None:
    """Run the full lineage chain guarded by WANDB.LOGGING flags, mirroring
    the reference's ``__main__`` (artifact_logging.py:394-412)."""
    store = store_from_config(cfg)
    flags = cfg["WANDB"]["LOGGING"]
    if flags.get("IMAGES"):
        store.log_images(cfg["PATHS"]["FRAME_TABLE"],
                         cfg["PATHS"]["CLIPS_TABLE"],
                         frames_dir=cfg["PATHS"]["FRAMES"])
    if flags.get("MODEL_DEV_HOLDOUT"):
        store.log_model_dev_holdout(cfg)
    if flags.get("TRAIN_VAL_TEST"):
        store.log_train_val_test(cfg)
    if flags.get("K_FOLD_CROSS_VAL"):
        store.log_k_fold_cross_val(cfg)


def main(argv=None) -> None:
    import argparse

    from ab_line_classifier_torch.config import load_config

    p = argparse.ArgumentParser(
        description="Log the dataset artifacts WANDB.LOGGING enables into "
                    "the local store (TRACKER.ARTIFACTS_DIR)")
    p.add_argument("--config", default=None, help="path to config.yml")
    log_all(load_config(p.parse_args(argv).config))


if __name__ == "__main__":
    main()
