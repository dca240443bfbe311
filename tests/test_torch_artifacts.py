"""PyTorch port, the artifact store (``data/artifacts.py``): the lineage
(Images -> ModelDev + Holdout -> TrainValTest and KFoldCrossValidation)
logged by the JAX package reads the same through the port, and the
reverse: the same versions, metadata and tables, and the same files,
byte for byte (the store writes no timestamps). Also the commit marker
(a version without ``metadata.json`` never resolves), version counting,
``log_all`` under ``WANDB.LOGGING`` and the module's CLI, and
``resolve_datasets`` / ``resolve_kfold_tables`` reading the store (source
3) as the JAX package's do.
"""

import os
import subprocess
import sys

import pandas as pd
import pytest
import yaml

from conftest import REPO_ROOT, cli_env, derive_workspace_config

from ab_line_classifier_tpu.config import Config as JaxConfig
from ab_line_classifier_tpu.data import artifacts as JA
from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.data import artifacts as A

STAGES = (A.IMAGES, A.MODEL_DEV, A.HOLDOUT, A.TRAIN_VAL_TEST, A.K_FOLD)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("torch_artifacts"))
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=25,
                                        clips_per_patient=2,
                                        frames_per_clip=3, hw=(16, 16))
    d = derive_workspace_config(ws, fcsv, ccsv, fdir)
    d["TRAIN"]["N_FOLDS"] = 4
    return ws, d, fcsv, ccsv, fdir


def log_lineage(mod, config_cls, root, d, fcsv, ccsv, fdir):
    store = mod.ArtifactStore(root)
    cfg = config_cls(d)
    store.log_images(fcsv, ccsv, frames_dir=fdir)
    store.log_model_dev_holdout(cfg)
    store.log_train_val_test(cfg)
    store.log_k_fold_cross_val(cfg)
    return store


def tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reads_the_same_from_either_package(dataset, writer):
    ws, d, fcsv, ccsv, fdir = dataset
    root = os.path.join(ws, f"store_{writer}")
    mod, cls = (JA, JaxConfig) if writer == "jax" else (A, Config)
    log_lineage(mod, cls, root, d, fcsv, ccsv, fdir)
    jax_store, port_store = JA.ArtifactStore(root), A.ArtifactStore(root)
    for name in STAGES:
        assert port_store.versions(name) == jax_store.versions(name) == ["v0"]
        assert port_store.resolve(name) == jax_store.resolve(name)
        assert port_store.metadata(name) == jax_store.metadata(name)
    for got, want in zip(port_store.get_train_val_test_artifact(),
                         jax_store.get_train_val_test_artifact()):
        if isinstance(want, pd.DataFrame):
            pd.testing.assert_frame_equal(got, want)
        else:
            assert got == want == os.path.abspath(fdir)
    assert port_store.get_n_folds() == jax_store.get_n_folds() == 4
    for fold_id in range(4):
        for got, want in zip(port_store.get_fold_artifact(fold_id),
                             jax_store.get_fold_artifact(fold_id)):
            if isinstance(want, pd.DataFrame):
                pd.testing.assert_frame_equal(got, want)
            else:
                assert got == want


def test_both_packages_write_the_same_files(dataset):
    ws, d, fcsv, ccsv, fdir = dataset
    jax_root, port_root = (os.path.join(ws, "same_jax"),
                           os.path.join(ws, "same_port"))
    log_lineage(JA, JaxConfig, jax_root, d, fcsv, ccsv, fdir)
    log_lineage(A, Config, port_root, d, fcsv, ccsv, fdir)
    want, got = tree(jax_root), tree(port_root)
    assert sorted(got) == sorted(want)
    assert any(k.endswith(os.path.join("fold_3", "clips.csv")) for k in got)
    for k in want:
        assert got[k] == want[k], k


def test_versions_and_the_commit_marker(dataset, tmp_path):
    _, _, fcsv, ccsv, fdir = dataset
    store = A.ArtifactStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.resolve(A.IMAGES)
    assert store.log_images(fcsv, ccsv, frames_dir=fdir).endswith("v0")
    partial = tmp_path / A.IMAGES / "v1"
    partial.mkdir()
    (partial / "stale_leftover.csv").write_text("junk")
    # A version without its metadata.json is a log that crashed.
    assert store.versions(A.IMAGES) == ["v0"]
    with pytest.raises(FileNotFoundError):
        store.resolve(A.IMAGES, "v1")
    relog = store.log_images(fcsv, ccsv, frames_dir=fdir)
    assert relog.endswith("v1") and store.resolve(A.IMAGES) == relog
    assert not os.path.exists(os.path.join(relog, "stale_leftover.csv"))
    assert store.metadata(A.IMAGES)["artifact_version"] == "v1"
    assert JA.ArtifactStore(str(tmp_path)).versions(A.IMAGES) == ["v0", "v1"]


def test_log_all_and_its_cli(dataset):
    ws, d, *_ = dataset
    d = yaml.safe_load(yaml.safe_dump(d))
    d["TRACKER"]["ARTIFACTS_DIR"] = os.path.join(ws, "store_cli")
    d["WANDB"]["LOGGING"] = {"IMAGES": True, "MODEL_DEV_HOLDOUT": True,
                             "K_FOLD_CROSS_VAL": False,
                             "TRAIN_VAL_TEST": True}
    path = os.path.join(ws, "cli.yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    r = subprocess.run([sys.executable, "-m",
                        "ab_line_classifier_torch.data.artifacts",
                        "--config", path], capture_output=True, text=True,
                       timeout=300, cwd=REPO_ROOT, env=cli_env(path))
    assert r.returncode == 0, r.stderr[-3000:]
    store = A.store_from_config(Config(d))
    assert [store.versions(n) for n in STAGES] == [["v0"]] * 4 + [[]]
    A.log_all(Config(d))
    assert store.versions(A.TRAIN_VAL_TEST) == ["v0", "v1"]


def test_experiments_resolve_the_store_like_jax(dataset):
    """``resolve_datasets`` takes the store's TrainValTest (source 3) and
    ``resolve_kfold_tables`` its KFold artifact, as the JAX package's do;
    an artifact's frames_dir wins only while it exists."""
    from ab_line_classifier_tpu.train import experiment as JE
    from ab_line_classifier_torch.train import experiment as E

    ws, d, fcsv, ccsv, fdir = dataset
    d = yaml.safe_load(yaml.safe_dump(d))
    d["TRACKER"]["ARTIFACTS_DIR"] = os.path.join(ws, "store_resolve")
    d["PATHS"]["PARTITIONS"] = os.path.join(ws, "no_partitions")
    d["PATHS"]["K_FOLDS_SPLIT_PATH"] = os.path.join(ws, "no_folds")
    log_lineage(A, Config, d["TRACKER"]["ARTIFACTS_DIR"], d, fcsv, ccsv,
                fdir)
    got = E.resolve_datasets(Config(d))
    want = JE.resolve_datasets(JaxConfig(d))
    for g, w in zip(got[:3], want[:3]):
        pd.testing.assert_frame_equal(g, w)
    assert got[3] == want[3] == os.path.abspath(fdir)
    got, want = E.resolve_kfold_tables(Config(d)), JE.resolve_kfold_tables(
        JaxConfig(d))
    assert len(got[0]) == len(want[0]) == 4 and got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        pd.testing.assert_frame_equal(g, w)
    assert E._live_dir("/no/such/dir", "fallback") == "fallback"
