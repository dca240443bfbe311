"""PyTorch port, W&B artifact adapters (``data/wandb_artifacts.py``) and the
pinned-version sources of ``train/experiment.py`` against the JAX
package's.

A stand-in W&B server (``init`` runs with ``use_artifact`` /
``log_artifact``, ``Artifact`` staging ``add_file`` / ``add_dir``, and an
``Api`` view whose ``artifact(name).download()`` serves what was
published) records every call. Held exactly: the calls both packages'
loggers and ``publish_all`` make (artifact names, types, descriptions,
metadata, the files and directories added, ``use_artifact`` lineage
edges) over one local lineage (synthetic frames of 25 patients); the
tables both packages' fetchers commit into their stores (byte for byte,
metadata included) and the artifacts they request, for TrainValTest and
KFold lineage walks, pinned and ``latest`` fetches and a moved upstream;
``resolve_datasets`` / ``resolve_kfold_tables`` with a pinned version
against the JAX package's (the tables equal; the second resolve served
from the store without a download). The module entry publishes the
flagged stages in a subprocess with a stand-in ``wandb`` on its path.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import types

import pandas as pd
import pytest
import yaml

from conftest import REPO_ROOT, cli_env, derive_workspace_config

from ab_line_classifier_tpu.config import Config as JaxConfig
from ab_line_classifier_tpu.config import load_config as jax_load_config
from ab_line_classifier_tpu.data import wandb_artifacts as jax_wa
from ab_line_classifier_tpu.data.artifacts import (
    ArtifactStore as JaxArtifactStore)
from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_tpu.train import experiment as jax_experiment
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.data import wandb_artifacts as wa
from ab_line_classifier_torch.data.artifacts import (
    HOLDOUT, IMAGES, K_FOLD, MODEL_DEV, TRAIN_VAL_TEST, ArtifactStore)
from ab_line_classifier_torch.train import experiment as E


class StandInServer:
    """A ``wandb``-module stand-in with an in-memory artifact server that
    materializes files; ``calls`` lists every call the adapters make, with
    paths relative to ``rel`` so two publishes of one lineage compare."""

    def __init__(self, root, rel=""):
        self.root, self.rel = root, rel
        self.artifacts, self.calls, self.downloads = {}, [], []
        server = self

        class Artifact:
            def __init__(self, name, type=None, description=None,
                         metadata=None):
                self.name, self.type = name, type
                self.description = description
                self.metadata = dict(metadata or {})
                self.adds = []
                server.calls.append(("Artifact", name, type, description,
                                     dict(self.metadata)))

            def add_file(self, local_path, name=None):
                assert os.path.isfile(local_path), local_path
                self.adds.append(("file", local_path, name))
                server.calls.append(("add_file", server._rel(local_path),
                                     name))

            def add_dir(self, local_path, name=None):
                assert os.path.isdir(local_path), local_path
                self.adds.append(("dir", local_path, name or ""))
                server.calls.append(("add_dir", server._rel(local_path),
                                     name))

        self.Artifact = Artifact

    def _rel(self, path):
        return os.path.relpath(path, self.rel) if self.rel else path

    def init(self, project=None, entity=None, job_type=None):
        self.calls.append(("init", project, entity, job_type))
        server = self

        class Run:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def use_artifact(self, spec):
                server.calls.append(("use_artifact", spec))
                return server.resolve(spec)

            def log_artifact(self, art):
                server.calls.append(("log_artifact", art.name))
                return server.commit(art)

        return Run()

    def resolve(self, spec):
        # "entity/project/" prefixes name the (one) project served here.
        name, _, version = spec.rpartition("/")[2].partition(":")
        versions = self.artifacts[name]
        if version in ("", "latest"):
            return versions[-1]
        return next(a for a in versions if a.version == version)

    def commit(self, staged):
        versions = self.artifacts.setdefault(staged.name, [])
        vid = f"v{len(versions)}"
        files_dir = os.path.join(self.root, staged.name, vid)
        os.makedirs(files_dir, exist_ok=True)
        for kind, local, artpath in staged.adds:
            dest = os.path.join(files_dir, artpath.rstrip("/"))
            if kind == "file":
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                shutil.copy(local, dest)
            else:
                shutil.copytree(local, dest, dirs_exist_ok=True)
        server = self
        art = types.SimpleNamespace(name=staged.name, type=staged.type,
                                    metadata=staged.metadata, version=vid)

        def download():
            server.downloads.append(f"{staged.name}:{vid}")
            return files_dir

        art.download = download
        versions.append(art)
        return art

    def Api(self):
        server = self

        class _Api:
            requested = []

            def artifact(self, spec):
                self.requested.append(spec)
                return server.resolve(spec)

        return _Api()


def tree(path):
    """``{relative path: bytes}`` of every file under ``path``."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


@pytest.fixture(scope="module")
def lineage(tmp_path_factory):
    """A committed local lineage, logged once by the JAX package's store
    (both packages' stores read the same layout)."""
    ws = str(tmp_path_factory.mktemp("torch_wandb_ws"))
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=25,
                                        clips_per_patient=2,
                                        frames_per_clip=2, hw=(16, 16),
                                        seed=11)
    cfg = jax_load_config(os.path.join(REPO_ROOT, "config.yml"))
    root = os.path.join(ws, "artifacts")
    store = JaxArtifactStore(root)
    store.log_images(fcsv, ccsv, frames_dir=fdir)
    store.log_model_dev_holdout(cfg)
    store.log_train_val_test(cfg)
    store.log_k_fold_cross_val(cfg)
    return ws, root, cfg.to_dict()


def publish(pkg, root, server_root, flags=None, d=None):
    """Publish the lineage at ``root`` through ``pkg``'s logger (every
    stage) or, with ``flags``, through its ``publish_all``."""
    store_cls = JaxArtifactStore if pkg is jax_wa else ArtifactStore
    server = StandInServer(server_root, rel=root)
    if flags is None:
        logger = pkg.WandbArtifactLogger(store_cls(root), project="ab_line",
                                         entity="team", wandb_module=server)
        published = [logger.log_images(), logger.log_model_dev_holdout(),
                     logger.log_train_val_test(),
                     logger.log_k_fold_cross_val()]
    else:
        d = dict(d, WANDB=dict(d["WANDB"], LOGGING=flags))
        published = pkg.publish_all(d, store=store_cls(root),
                                    wandb_module=server)
    return server, published


def test_loggers_make_identical_calls(lineage, tmp_path):
    _, root, _ = lineage
    jax_server, jax_out = publish(jax_wa, root, str(tmp_path / "jax"))
    server, out = publish(wa, root, str(tmp_path / "port"))
    assert out == jax_out == ["v0", ("v0", "v0"), "v0", "v0"]
    assert server.calls == jax_server.calls
    used = [c[1] for c in server.calls if c[0] == "use_artifact"]
    assert used == [f"{IMAGES}:v0", f"{MODEL_DEV}:v0", f"{MODEL_DEV}:v0"]
    assert [c[1] for c in server.calls if c[0] == "log_artifact"] == [
        IMAGES, MODEL_DEV, HOLDOUT, TRAIN_VAL_TEST, K_FOLD]
    for name in server.artifacts:
        assert (tree(server.artifacts[name][-1].download())
                == tree(jax_server.artifacts[name][-1].download()))


@pytest.mark.parametrize("flags", [
    {"IMAGES": True, "MODEL_DEV_HOLDOUT": True, "K_FOLD_CROSS_VAL": True,
     "TRAIN_VAL_TEST": True},
    {"IMAGES": True, "MODEL_DEV_HOLDOUT": True, "K_FOLD_CROSS_VAL": False,
     "TRAIN_VAL_TEST": True},
    {"IMAGES": False, "MODEL_DEV_HOLDOUT": False, "K_FOLD_CROSS_VAL": False,
     "TRAIN_VAL_TEST": False},
])
def test_publish_all_makes_identical_calls(lineage, tmp_path, flags):
    _, root, d = lineage
    jax_server, jax_out = publish(jax_wa, root, str(tmp_path / "jax"),
                                  flags, d)
    server, out = publish(wa, root, str(tmp_path / "port"), flags, d)
    assert out == jax_out
    assert server.calls == jax_server.calls
    assert set(out) == ({IMAGES, MODEL_DEV, HOLDOUT, TRAIN_VAL_TEST,
                         K_FOLD} if flags["K_FOLD_CROSS_VAL"] else
                        {IMAGES, MODEL_DEV, HOLDOUT, TRAIN_VAL_TEST}
                        if flags["IMAGES"] else set())
    if flags["IMAGES"]:
        meta = server.artifacts[IMAGES][-1].metadata
        assert meta["automask_version"] == d["DATA"]["AUTOMASK"]["VERSION"]


@pytest.fixture()
def published(lineage, tmp_path):
    """The lineage published on a stand-in server, for the fetchers."""
    _, root, _ = lineage
    server, _ = publish(jax_wa, root, str(tmp_path / "server"))
    return server


def fetch_both(server, tmp_path, steps):
    """Run ``steps(fetcher)`` on each package's fetcher into a fresh store
    over one server; return the stores' trees and the requests."""
    out = {}
    for name, pkg, store_cls in (("jax", jax_wa, JaxArtifactStore),
                                 ("port", wa, ArtifactStore)):
        api = server.Api()
        api.requested = []
        store = store_cls(str(tmp_path / f"store_{name}"))
        steps(pkg.WandbArtifactFetcher(store, api=api))
        out[name] = (tree(store.root), list(api.requested))
    return out


@pytest.mark.parametrize("steps", [
    lambda f: f.fetch_train_val_test(),
    lambda f: f.fetch_k_fold(),
    lambda f: f.fetch_k_fold("v0", val_split=0.2, random_seed=7),
    lambda f: [f.fetch_train_val_test("v0") for _ in range(2)],
    lambda f: [f.fetch_images("latest") for _ in range(2)]
    + [f.fetch_images("v0")] * 2,
], ids=["tvt", "kfold", "kfold_overrides", "tvt_twice", "images"])
def test_fetchers_commit_identical_stores(published, tmp_path, steps):
    out = fetch_both(published, tmp_path, steps)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0] == out["jax"][0]
    metas = [json.loads(v) for k, v in out["port"][0].items()
             if k.endswith("metadata.json")]
    assert metas and all(m["source"].startswith("wandb:") for m in metas)


def test_moved_upstream_commits_a_new_version(lineage, tmp_path):
    """'latest' is fetched again each time: an unmoved upstream is not
    committed twice, a moved one is (JAX ``tests/test_wandb_artifacts.py``,
    the same steps through both packages)."""
    _, root, _ = lineage
    out = {}
    for name, pkg, store_cls in (("jax", jax_wa, JaxArtifactStore),
                                 ("port", wa, ArtifactStore)):
        server, _ = publish(jax_wa, root, str(tmp_path / f"server_{name}"))
        store = store_cls(str(tmp_path / f"store_{name}"))
        fetcher = pkg.WandbArtifactFetcher(store, api=server.Api())
        paths = [fetcher.fetch_images()[0], fetcher.fetch_images()[0]]
        frames_csv = os.path.join(server.artifacts[IMAGES][-1].download(),
                                  "frames.csv")
        df = pd.read_csv(frames_csv)
        df.iloc[:-1].to_csv(frames_csv, index=False)
        paths += [fetcher.fetch_images()[0], fetcher.fetch_images()[0]]
        out[name] = ([os.path.relpath(p, store.root) for p in paths],
                     {k: v for k, v in tree(store.root).items()
                      if not k.endswith("metadata.json")})
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["Images/v0", "Images/v0", "Images/v1",
                              "Images/v1"]


def test_fetcher_and_logger_need_wandb_without_stand_ins(tmp_path,
                                                         monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    store = ArtifactStore(str(tmp_path / "s"))
    for pkg, st in ((jax_wa, JaxArtifactStore(store.root)), (wa, store)):
        with pytest.raises(ImportError, match="wandb is not installed"):
            pkg.WandbArtifactFetcher(st)
        with pytest.raises(ImportError, match="wandb is not installed"):
            pkg.WandbArtifactLogger(st, project="p")


# -- pinned versions through resolve_datasets / resolve_kfold_tables --------
@pytest.fixture()
def pinned_world(lineage, tmp_path, monkeypatch):
    """A workspace config whose store is empty, the lineage published on
    a stand-in server, and ``wandb`` in ``sys.modules`` serving it."""
    ws, root, _ = lineage
    server, _ = publish(jax_wa, root, str(tmp_path / "server"))
    monkeypatch.setitem(sys.modules, "wandb", server)
    fcsv = os.path.join(ws, "frames.csv")
    d = derive_workspace_config(str(tmp_path), fcsv, fcsv, ws)
    return server, d


def _pinned(d, store_dir, key, ver):
    d = yaml.safe_load(yaml.safe_dump(d))
    d["TRACKER"]["ARTIFACTS_DIR"] = store_dir
    d["WANDB"][key] = ver
    return d


@pytest.mark.parametrize("ver", ["v0", "latest"])
def test_pinned_split_resolves_like_jax(pinned_world, tmp_path, ver):
    server, d = pinned_world
    key = "TRAIN_VAL_TEST_ARTIFACT_VERSION"
    want = jax_experiment.resolve_datasets(
        JaxConfig(_pinned(d, str(tmp_path / "jax_store"), key, ver)))
    cfg = Config(_pinned(d, str(tmp_path / "port_store"), key, ver))
    server.downloads.clear()
    got = E.resolve_datasets(cfg)
    assert server.downloads  # fetched
    for g, w in zip(got[:3], want[:3]):
        pd.testing.assert_frame_equal(g, w)
    assert got[3] == want[3] and os.path.isdir(got[3])
    server.downloads.clear()
    again = E.resolve_datasets(cfg)
    assert (server.downloads == []) == (ver != "latest")
    for g, w in zip(again[:3], got[:3]):
        pd.testing.assert_frame_equal(g, w)
    store = ArtifactStore(str(tmp_path / "port_store"))
    meta = store.metadata(TRAIN_VAL_TEST)
    assert meta["source"] == f"wandb:{TRAIN_VAL_TEST}:{ver}"
    assert filecmp.cmp(
        os.path.join(store.resolve(TRAIN_VAL_TEST), "frames", "train.csv"),
        os.path.join(server.artifacts[TRAIN_VAL_TEST][-1].download(),
                     "frames", "train.csv"), shallow=False)


def test_pinned_folds_resolve_like_jax(pinned_world, tmp_path):
    server, d = pinned_world
    key = "K_FOLD_CROSS_VAL_ARTIFACT_VERSION"
    want = jax_experiment.resolve_kfold_tables(
        JaxConfig(_pinned(d, str(tmp_path / "jax_store"), key, "v0")))
    cfg = Config(_pinned(d, str(tmp_path / "port_store"), key, "v0"))
    got = E.resolve_kfold_tables(cfg)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        pd.testing.assert_frame_equal(g, w)
    assert got[1:] == want[1:]
    server.downloads.clear()
    E.resolve_kfold_tables(cfg)
    assert server.downloads == []


def test_module_entry_publishes_flagged_stages(lineage, tmp_path):
    """``python -m ab_line_classifier_torch.data.wandb_artifacts --config``
    with a stand-in ``wandb`` module on the path."""
    _, root, d = lineage
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "wandb.py").write_text(
        "import json, os\n"
        "LOG = os.environ['STAND_IN_LOG']\n"
        "class Artifact:\n"
        "    def __init__(self, name, type=None, description=None,"
        " metadata=None):\n"
        "        self.name, self.metadata = name, dict(metadata or {})\n"
        "    def add_file(self, p, name=None): pass\n"
        "    def add_dir(self, p, name=None): pass\n"
        "class _Run:\n"
        "    def __enter__(self): return self\n"
        "    def __exit__(self, *e): return False\n"
        "    def use_artifact(self, spec):\n"
        "        return type('A', (), {'version': 'v0'})()\n"
        "    def log_artifact(self, art):\n"
        "        with open(LOG, 'a') as f:\n"
        "            f.write(json.dumps([art.name, art.metadata]) + '\\n')\n"
        "        art.version = 'v0'\n"
        "        return art\n"
        "def init(**kw): return _Run()\n")
    d = yaml.safe_load(yaml.safe_dump(d))
    d["TRACKER"]["ARTIFACTS_DIR"] = root
    d["WANDB"]["LOGGING"] = {"IMAGES": False, "MODEL_DEV_HOLDOUT": True,
                             "K_FOLD_CROSS_VAL": True,
                             "TRAIN_VAL_TEST": False}
    cfg_path = str(tmp_path / "config.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(d, f)
    log = str(tmp_path / "published.jsonl")
    env = cli_env(cfg_path, {"STAND_IN_LOG": log})
    env["PYTHONPATH"] = str(stub) + os.pathsep + env["PYTHONPATH"]
    r = subprocess.run(
        [sys.executable, "-m", "ab_line_classifier_torch.data.wandb_artifacts",
         "--config", cfg_path], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    with open(log) as f:
        names = [json.loads(line)[0] for line in f]
    assert names == [MODEL_DEV, HOLDOUT, K_FOLD]
