"""W&B artifact adapters for the local :class:`ArtifactStore`, both ways
(port of the JAX package's ``data/wandb_artifacts.py``).

- :class:`WandbArtifactFetcher` downloads reference-logged artifacts
  (TrainValTest and KFoldCrossValidation, walking their lineage to
  ModelDev and Images) once into the local store layout, each committed
  with ``source == wandb:<name>:<version>``; afterwards every trainer works
  from the store with no W&B on the hot path.
- :class:`WandbArtifactLogger` publishes the store's committed lineage to
  W&B with the reference's artifact names, ``type='dataset'``,
  descriptions, metadata keys and lineage edges (``use_artifact`` on the
  parent inside each logging run).

``python -m ab_line_classifier_torch.data.wandb_artifacts [--config C]``
publishes the stages that the ``WANDB.LOGGING`` flags enable
(:func:`publish_all`). wandb is not a dependency: it is imported only when
no ``api=`` (fetch) or ``wandb_module=`` (publish) stand-in is given. The
tables are copied as files, never parsed, so this module needs no pandas.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

from ab_line_classifier_torch.data.artifacts import (
    ArtifactStore, HOLDOUT, IMAGES, K_FOLD, MODEL_DEV, TRAIN_VAL_TEST)


def _same_tree(a: str, b: str) -> bool:
    """Byte-identical file trees (metadata.json excluded)?"""
    import filecmp

    def rel_files(root):
        out = {}
        for dirpath, _dirs, files in os.walk(root):
            for fn in files:
                if fn == "metadata.json":
                    continue
                full = os.path.join(dirpath, fn)
                out[os.path.relpath(full, root)] = full
        return out

    fa, fb = rel_files(a), rel_files(b)
    if fa.keys() != fb.keys():
        return False
    return all(filecmp.cmp(fa[r], fb[r], shallow=False) for r in fa)


def _default_api():
    try:
        import wandb
    except ImportError as e:  # wandb is optional
        raise ImportError(
            "wandb is not installed; pass an api= object or use the "
            "local-first ArtifactStore lineage instead") from e
    return wandb.Api()


def _default_wandb_module():
    try:
        import wandb
    except ImportError as e:  # wandb is optional
        raise ImportError(
            "wandb is not installed; pass wandb_module= (a module-like "
            "object with init() and Artifact) to publish artifacts") from e
    return wandb


class WandbArtifactFetcher:
    """Fetch reference-logged W&B artifacts into a local ArtifactStore.

    :param store: destination local store.
    :param project: ``entity/project`` prefix for artifact names
        (e.g. ``"myteam/ab-line"``); empty uses the api default.
    :param api: a ``wandb.Api()``-like object exposing
        ``artifact(name) -> obj`` with ``.metadata`` (dict) and
        ``.download() -> local dir``. Injected in tests.
    """

    def __init__(self, store: ArtifactStore, *, project: str = "",
                 api=None):
        self.store = store
        self.prefix = f"{project}/" if project else ""
        self.api = api if api is not None else _default_api()

    def _get(self, name: str, version: str):
        v = version if version else "latest"
        return self.api.artifact(f"{self.prefix}{name}:{v}")

    def _commit(self, name: str, path: str, meta: dict) -> str:
        """Commit a staged version dir — unless it duplicates the newest
        committed version (same metadata, identical file content), in
        which case the staged dir is dropped and the existing version is
        returned. Unpinned ``'latest'`` fetches must always re-check wandb
        (the alias can move), but repeated sweeps/CV runs against an
        unmoved upstream would otherwise grow the store unboundedly with
        identical copies."""
        for v in reversed(self.store.versions(name)):
            prev_meta = {k: w for k, w
                         in self.store.metadata(name, v).items()
                         if k != "artifact_version"}
            if prev_meta.get("source") != meta.get("source"):
                continue  # only the newest version of the SAME source
            prev = self.store.resolve(name, v)
            if prev_meta == meta and _same_tree(prev, path):
                shutil.rmtree(path)
                return prev
            break
        self.store._write_meta(path, meta)
        return path

    def _materialized_images(self, version: str) -> Optional[Tuple[str, str]]:
        """Local Images version already fetched for this wandb version, if
        any — so lineage walks (TrainValTest then KFold, or a re-run) don't
        re-download and re-materialize the same Images artifact."""
        if version in ("", "latest", None):
            return None  # "latest" can move upstream; always re-check
        want = f"wandb:{IMAGES}:{version}"
        for v in reversed(self.store.versions(IMAGES)):
            meta = self.store.metadata(IMAGES, v)
            if meta.get("source") == want and meta.get("frames_dir"):
                # The frame files live in the W&B download cache, which can
                # be cleared independently of the store — a stale hit here
                # would permanently skip the only re-download path.
                if os.path.isdir(meta["frames_dir"]):
                    return self.store.resolve(IMAGES, v), meta["frames_dir"]
        return None

    # ------------------------------------------------------------------
    def fetch_images(self, version: str = "latest") -> Tuple[str, str]:
        """Download the Images artifact; returns (store path, frames dir).

        The frame files stay in the W&B download cache (referenced by the
        metadata ``frames_dir``, exactly like locally-logged Images).
        A pinned version that is already materialized in the local store is
        served from it without touching wandb."""
        cached = self._materialized_images(version)
        if cached is not None:
            return cached
        art = self._get(IMAGES, version)
        src = art.download()
        frames_dir = os.path.join(src, "frames")
        path = self.store.new_version_dir(IMAGES)
        for fname in ("frames.csv", "clips_table.csv"):
            if os.path.isfile(os.path.join(src, fname)):
                shutil.copy(os.path.join(src, fname),
                            os.path.join(path, fname))
        path = self._commit(IMAGES, path, {
            "type": "dataset", "source": f"wandb:{IMAGES}:{version}",
            "frames_dir": os.path.abspath(frames_dir)
            if os.path.isdir(frames_dir) else None})
        return path, frames_dir

    def fetch_train_val_test(self, version: str = "latest") -> str:
        """Reference ``get_train_val_test_artifact`` (train_utils.py:18-46):
        walk the TrainValTest -> ModelDev -> Images lineage, download the
        split tables + frames, and materialize a local TrainValTest version.
        Returns the local artifact path; after this,
        ``store.get_train_val_test_artifact()`` serves it with no wandb."""
        tvt = self._get(TRAIN_VAL_TEST, version)
        model_dev_v = tvt.metadata.get("model_dev_artifact_version")
        images_v = None
        if model_dev_v:
            model_dev = self._get(MODEL_DEV, model_dev_v)
            images_v = model_dev.metadata.get("images_artifact_version")
        _, frames_dir = self.fetch_images(images_v or "latest")

        src = os.path.join(tvt.download(), "frames")
        path = self.store.new_version_dir(TRAIN_VAL_TEST)
        os.makedirs(os.path.join(path, "frames"), exist_ok=True)
        for split in ("train", "val", "test"):
            shutil.copy(os.path.join(src, f"{split}.csv"),
                        os.path.join(path, "frames", f"{split}.csv"))
        return self._commit(TRAIN_VAL_TEST, path, {
            "type": "dataset",
            "source": f"wandb:{TRAIN_VAL_TEST}:{version}",
            "frames_dir": os.path.abspath(frames_dir)
            if os.path.isdir(frames_dir) else None})

    def fetch_k_fold(self, version: str = "latest",
                     val_split: Optional[float] = None,
                     random_seed: Optional[int] = None) -> str:
        """Reference ``get_fold_artifact`` lineage (train_utils.py:162-235):
        download the k-fold artifact's per-fold frame tables into the local
        KFoldCrossValidation layout. ``val_split``/``random_seed`` fill the
        metadata the local fetcher needs to rebuild fold train/val splits —
        both resolve the same way: an explicitly-passed value wins over the
        artifact's metadata, which wins over the defaults (0.1 / 42)."""
        art = self._get(K_FOLD, version)
        n_folds = int(art.metadata["n_folds"])
        # Walk the same lineage as fetch_train_val_test: KFold artifacts
        # record their PARENT ModelDev version ('model_dev_artifact_
        # version', reference artifact_logging.py:266-332 and our
        # log_k_fold_cross_val), and the ModelDev hop yields the Images
        # version. Reading 'images_artifact_version' off the KFold
        # metadata directly would always miss (the key only exists on
        # ModelDev) and silently pair the fold tables with whatever
        # Images version is currently 'latest' — wrong pixels for the
        # fold labels if Images was re-logged since.
        images_v = art.metadata.get("images_artifact_version")
        if not images_v:
            model_dev_v = art.metadata.get("model_dev_artifact_version")
            if model_dev_v:
                model_dev = self._get(MODEL_DEV, model_dev_v)
                images_v = model_dev.metadata.get("images_artifact_version")
        _, frames_dir = self.fetch_images(images_v or "latest")
        src = art.download()
        path = self.store.new_version_dir(K_FOLD)
        for i in range(n_folds):
            os.makedirs(os.path.join(path, f"fold_{i}"), exist_ok=True)
            shutil.copy(os.path.join(src, f"fold_{i}", "frames.csv"),
                        os.path.join(path, f"fold_{i}", "frames.csv"))
        return self._commit(K_FOLD, path, {
            "type": "dataset", "source": f"wandb:{K_FOLD}:{version}",
            "n_folds": n_folds,
            "val_split": float(val_split
                               if val_split is not None
                               else art.metadata.get("val_split", 0.1)),
            "random_seed": int(random_seed
                               if random_seed is not None
                               else art.metadata.get("random_seed", 42)),
            "frames_dir": os.path.abspath(frames_dir)
            if os.path.isdir(frames_dir) else None})


# ---------------------------------------------------------------------------
# Publish side: local ArtifactStore lineage -> W&B
# ---------------------------------------------------------------------------

#: W&B artifact descriptions, verbatim from the reference UI surface
#: (artifact_logging.py:69, 133, 142, 251, 295) — part of the artifact-hub
#: contract a migrating team sees in the W&B app.
_DESCRIPTIONS = {
    IMAGES: "Holds images, frames table, clips table, and sql query.",
    MODEL_DEV: "Frames table and clips table for model research and "
               "development.",
    HOLDOUT: "Frames table and clips table held out for final model "
             "validation.",
    TRAIN_VAL_TEST: "Derivative of ModelDev artifact. Artifact used to "
                    "directly run model training.",
    K_FOLD: "Derivative of ModelDev artifact. Used to validate model "
            "performance with k-folds.",
}


class WandbArtifactLogger:
    """Publish the local store's committed lineage to W&B.

    Counterpart to the reference's ``log_images`` / ``log_dev_and_holdout``
    / ``log_train_val_test`` / ``log_k_fold_cross_val``
    (``src/data/artifact_logging.py:54-332``), with one structural
    difference: the reference *derives* each child artifact inside the
    logging run (download parent from W&B, split, upload), whereas here the
    derivation already happened locally and crash-consistently
    (``ArtifactStore.log_*``) — the logger publishes those committed
    versions. The W&B surface is identical: same artifact names, ``type=
    'dataset'``, descriptions, metadata keys, file layout, and a
    ``use_artifact`` call on the parent inside each logging run so W&B
    records the same lineage edges.

    :param store: the local store whose versions are published.
    :param project: W&B project name (``WANDB.PROJECT_NAME``).
    :param entity: W&B entity (``WANDB.ENTITY``; empty uses the default).
    :param wandb_module: a ``wandb``-module-like object exposing
        ``init(project=, entity=, job_type=) -> run`` (context manager with
        ``use_artifact``/``log_artifact``) and ``Artifact(name, type=,
        description=, metadata=)`` with ``add_file``/``add_dir``. Injected
        in tests; defaults to the real ``wandb``.
    """

    def __init__(self, store: ArtifactStore, *, project: str,
                 entity: str = "", wandb_module=None):
        self.store = store
        self.project = project
        self.entity = entity
        self.wandb = (wandb_module if wandb_module is not None
                      else _default_wandb_module())
        # local version -> W&B-assigned version, per artifact name; lets a
        # chain published in one session pin exact parent versions in
        # child metadata (the reference reads parent.version the same way,
        # artifact_logging.py:131,253,297).
        self._published: Dict[Tuple[str, str], str] = {}

    # -- plumbing ----------------------------------------------------------
    def _run(self):
        return self.wandb.init(project=self.project, entity=self.entity,
                               job_type="log-artifact")

    def _record(self, name: str, local_version: str, logged) -> str:
        """Remember the W&B version assigned to a just-published artifact.

        Real wandb assigns the version server-side: ``log_artifact``
        returns an artifact whose ``.version`` is populated after
        ``.wait()``. Both are optional on injected fakes."""
        wait = getattr(logged, "wait", None)
        if callable(wait):
            wait()
        version = getattr(logged, "version", None) or "latest"
        self._published[(name, local_version)] = version
        return version

    def _parent_wandb_version(self, run, name: str,
                              local_version: Optional[str]) -> str:
        """Resolve + lineage-mark the parent artifact inside ``run``.

        If the parent local version was published in this session, use its
        recorded W&B version; otherwise fall back to ``latest`` (publishing
        a child whose parent was uploaded by an earlier session). The
        ``use_artifact`` call is what makes W&B draw the lineage edge —
        same mechanism as the reference (artifact_logging.py:105,201,282).
        """
        pinned = self._published.get((name, local_version or ""), "latest")
        parent = run.use_artifact(f"{name}:{pinned}")
        return getattr(parent, "version", None) or pinned

    # -- lineage stages ----------------------------------------------------
    def log_images(self, version: str = "latest",
                   query_sql: Optional[str] = None,
                   extra_metadata: Optional[Dict] = None) -> str:
        """Publish a local Images version (artifact_logging.py:54-84).

        ``extra_metadata`` carries run-context keys the reference stores on
        the Images artifact (the automask settings, :71-75) — the store's
        own metadata doesn't record them, the config does, so
        :func:`publish_all` threads them through. ``query_sql`` is the
        clips SQL query file (added as ``clips_query.sql`` when present).
        Returns the W&B-assigned version."""
        path = self.store.resolve(IMAGES, version)
        local_v = os.path.basename(path)
        meta = dict(extra_metadata or {})
        with self._run() as run:
            art = self.wandb.Artifact(IMAGES, type="dataset",
                                      description=_DESCRIPTIONS[IMAGES],
                                      metadata=meta)
            frames_dir = self.store.metadata(IMAGES, version).get(
                "frames_dir")
            if frames_dir and os.path.isdir(frames_dir):
                art.add_dir(frames_dir, name="frames/")
            art.add_file(os.path.join(path, "clips_table.csv"),
                         name="clips_table.csv")
            art.add_file(os.path.join(path, "frames.csv"), name="frames.csv")
            if query_sql and os.path.isfile(query_sql):
                art.add_file(query_sql, name="clips_query.sql")
            logged = run.log_artifact(art)
        return self._record(IMAGES, local_v, logged)

    def log_model_dev_holdout(self, version: str = "latest"
                              ) -> Tuple[str, str]:
        """Publish the ModelDev + Holdout pair (artifact_logging.py:87-148,
        335-370): one run, both artifacts, shared Images provenance.
        Returns their W&B-assigned versions."""
        out = []
        with self._run() as run:
            # both committed by one split run; ModelDev's meta is the pair's
            dev_meta = self.store.metadata(MODEL_DEV, version)
            images_v = self._parent_wandb_version(
                run, IMAGES, dev_meta.get("images_artifact_version"))
            for name in (MODEL_DEV, HOLDOUT):
                path = self.store.resolve(name, version)
                meta = self.store.metadata(name, version)
                art = self.wandb.Artifact(
                    name, type="dataset", description=_DESCRIPTIONS[name],
                    metadata={
                        "images_artifact_version": images_v,
                        "holdout_split": meta.get("holdout_split"),
                        "random_seed": meta.get("random_seed"),
                    })
                art.add_file(os.path.join(path, "frames.csv"),
                             name="frames.csv")
                art.add_file(os.path.join(path, "clips_table.csv"),
                             name="clips_table.csv")
                logged = run.log_artifact(art)
                out.append((name, os.path.basename(path), logged))
        return tuple(self._record(*rec) for rec in out)

    def log_train_val_test(self, version: str = "latest") -> str:
        """Publish a local TrainValTest version (artifact_logging.py:
        186-263): ``frames/`` + ``clips/`` split dirs, ModelDev provenance.
        Returns the W&B-assigned version."""
        path = self.store.resolve(TRAIN_VAL_TEST, version)
        meta = self.store.metadata(TRAIN_VAL_TEST, version)
        with self._run() as run:
            dev_v = self._parent_wandb_version(
                run, MODEL_DEV, meta.get("model_dev_artifact_version"))
            art = self.wandb.Artifact(
                TRAIN_VAL_TEST, type="dataset",
                description=_DESCRIPTIONS[TRAIN_VAL_TEST],
                metadata={
                    "model_dev_artifact_version": dev_v,
                    "random_seed": meta.get("random_seed"),
                    "val_split": meta.get("val_split"),
                    "test_split": meta.get("test_split"),
                })
            art.add_dir(os.path.join(path, "frames"), name="frames")
            clips = os.path.join(path, "clips")
            if os.path.isdir(clips):
                art.add_dir(clips, name="clips")
            logged = run.log_artifact(art)
        return self._record(TRAIN_VAL_TEST, os.path.basename(path), logged)

    def log_k_fold_cross_val(self, version: str = "latest") -> str:
        """Publish a local KFoldCrossValidation version
        (artifact_logging.py:266-332): per-fold dirs, n_folds/seed/val_split
        metadata, ModelDev provenance. Returns the W&B-assigned version."""
        path = self.store.resolve(K_FOLD, version)
        meta = self.store.metadata(K_FOLD, version)
        n_folds = int(meta["n_folds"])
        with self._run() as run:
            dev_v = self._parent_wandb_version(
                run, MODEL_DEV, meta.get("model_dev_artifact_version"))
            art = self.wandb.Artifact(
                K_FOLD, type="dataset", description=_DESCRIPTIONS[K_FOLD],
                metadata={
                    "model_dev_artifact_version": dev_v,
                    "n_folds": n_folds,
                    "random_seed": meta.get("random_seed"),
                    "val_split": meta.get("val_split"),
                })
            for i in range(n_folds):
                art.add_dir(os.path.join(path, f"fold_{i}"),
                            name=f"fold_{i}")
            logged = run.log_artifact(art)
        return self._record(K_FOLD, os.path.basename(path), logged)


def publish_all(cfg, store: Optional[ArtifactStore] = None,
                wandb_module=None) -> Dict[str, str]:
    """Flag-gated publish of the local lineage, mirroring the reference's
    ``__main__`` (artifact_logging.py:394-412): each ``WANDB.LOGGING``
    flag publishes its stage, in the reference's order. Returns
    ``{artifact name: published W&B version}``."""
    from ab_line_classifier_torch.data.artifacts import store_from_config

    if store is None:
        store = store_from_config(cfg)
    flags = cfg["WANDB"]["LOGGING"]
    published: Dict[str, str] = {}
    if not any(flags.get(k) for k in ("IMAGES", "MODEL_DEV_HOLDOUT",
                                      "K_FOLD_CROSS_VAL", "TRAIN_VAL_TEST")):
        # stay local-first: no flags -> no wandb import (wandb is optional;
        # the reference's __main__ would still import it, this one doesn't)
        return published
    logger = WandbArtifactLogger(
        store, project=cfg["WANDB"]["PROJECT_NAME"],
        entity=cfg["WANDB"].get("ENTITY", ""), wandb_module=wandb_module)
    if flags.get("IMAGES"):
        automask = cfg.get("DATA", {}).get("AUTOMASK", {}) or {}
        published[IMAGES] = logger.log_images(
            query_sql=cfg.get("PATHS", {}).get("DATABASE_QUERY"),
            extra_metadata={
                # reference artifact_logging.py:71-75
                "automask_version": automask.get("VERSION"),
                "automask_output_format": automask.get("OUTPUT_FORMAT"),
                "automask_edge_preserve": automask.get("EDGE_PRESERVE"),
                "automask_save_cropped_roi":
                    automask.get("SAVE_CROPPED_ROI"),
            })
    if flags.get("MODEL_DEV_HOLDOUT"):
        dev_v, holdout_v = logger.log_model_dev_holdout()
        published[MODEL_DEV] = dev_v
        published[HOLDOUT] = holdout_v
    if flags.get("K_FOLD_CROSS_VAL"):
        published[K_FOLD] = logger.log_k_fold_cross_val()
    if flags.get("TRAIN_VAL_TEST"):
        published[TRAIN_VAL_TEST] = logger.log_train_val_test()
    return published


def main(argv=None) -> Dict[str, str]:
    import argparse

    from ab_line_classifier_torch.config import load_config

    p = argparse.ArgumentParser(
        description="Publish the local store's lineage (TRACKER."
                    "ARTIFACTS_DIR) to W&B, the stages WANDB.LOGGING "
                    "enables")
    p.add_argument("--config", default=None, help="path to config.yml")
    return publish_all(load_config(p.parse_args(argv).config))


if __name__ == "__main__":
    main()
