"""Rank program of the PyTorch port's multi-process tests (gloo on the CPU).

``python tests/torch_ranks.py CASE RANK WORLD PORT IN OUT`` starts rank
RANK of a WORLD-rank gloo group at 127.0.0.1:PORT (with a timeout), runs
the case on the inputs the test wrote to IN (``torch.save``), and rank 0
writes what it returns to OUT. A rank imports the port, torch and numpy:
never JAX, and never ``tests/conftest.py`` (which imports JAX and cv2).

:func:`run_ranks` is the tests' side: it writes the inputs, spawns the
ranks through ``parallel/multihost.py::spawn_ranks`` (a free port, one
deadline for all, a kill and the stderr tails on failure) and loads the
result.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from ab_line_classifier_torch.parallel import mesh as mesh_lib  # noqa: E402

CW = {0: 0.7, 1: 1.6}


def run_ranks(case: str, world: int, inputs, tmp_dir: str,
              timeout: float = 300.0):
    """Run ``case`` on ``world`` ranks with ``inputs``; rank 0's result."""
    from ab_line_classifier_torch.parallel.multihost import spawn_ranks

    inp = os.path.join(tmp_dir, f"{case}_{world}_in.pt")
    out = os.path.join(tmp_dir, f"{case}_{world}_out.pt")
    torch.save(inputs, inp)
    spawn_ranks(lambda r, port: [sys.executable, os.path.abspath(__file__),
                                 case, str(r), str(world), str(port), inp,
                                 out], world, timeout=timeout)
    return torch.load(out, weights_only=False)


def metric_fields(state):
    return {k: v.detach().cpu().clone() for k, v in vars(state).items()}


# -- cases ---------------------------------------------------------------
def case_mesh(a):
    """``tests/test_mesh.py``'s cases at 4 ranks."""
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.data.pipeline import (DeviceCachedDataset,
                                                        FrameArrays)
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.predict.predict import Predictor
    from ab_line_classifier_torch.train.loop import Trainer

    out = {}
    mesh = mesh_lib.make_mesh(n_data=-1, n_trial=2, device="cpu")
    mesh1 = mesh_lib.make_mesh(n_data=4, n_trial=1, device="cpu")
    out["shapes"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                     tuple(mesh1.shape))
    errors = []
    for n_data, n_trial in ((4, 2), (-1, 3), (2, 1)):
        try:
            mesh_lib.make_mesh(n_data, n_trial, device="cpu")
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    cfg_mesh = mesh_lib.mesh_from_config(
        Config({"PARALLEL": {"MESH": {"DATA": 2, "TRIAL": 2}}}), "cpu")
    out["config"] = (
        tuple(cfg_mesh.shape),
        mesh_lib.mesh_from_config(Config({}), "cpu") is None,
        mesh_lib.mesh_from_config(Config(
            {"PARALLEL": {"MESH": {"DATA": 5, "TRIAL": 3}}}), "cpu") is None)

    # Layouts: each rank's rows, gathered back.
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    out["data_rows"] = mesh_lib.fetch(torch.as_tensor(
        mesh_lib.shard_batch(mesh1, x)))
    out["trial_data_rows"] = mesh_lib.fetch(torch.as_tensor(
        mesh_lib.shard_batch(mesh, x)))
    out["full_rows"] = mesh_lib.fetch(torch.as_tensor(
        x[mesh_lib.full_batch_sharding(mesh, 16)]))
    out["trials"] = mesh_lib.fetch(torch.tensor(
        [mesh_lib.trial_replicated(mesh, 4).start,
         mesh_lib.trial_replicated(mesh, 3).stop]))

    # The toy loss's data-parallel gradients: the local sum over the
    # global count, summed over the data axis.
    rows = mesh_lib.batch_sharding(mesh1, 16)
    w = torch.as_tensor(a["w"]).requires_grad_()
    logp = torch.log_softmax(torch.as_tensor(a["x"][rows]) @ w, -1)
    y = torch.as_tensor(a["y"][rows]).long()
    (-logp.gather(1, y[:, None]).sum() / 16).backward()
    mesh_lib.all_reduce_tensors(
        [w.grad], mesh_lib.axis_group(mesh1, mesh_lib.DATA_AXIS))
    out["grad"] = w.grad.numpy()

    # Metrics: each rank its rows, one reduction.
    st = M.init_metrics(2)
    M.update_metrics(st, torch.as_tensor(a["probs"][rows]),
                     torch.as_tensor(a["labels_oh"][rows]))
    M.reduce_metrics(st, mesh_lib.axis_group(mesh1, mesh_lib.DATA_AXIS))
    out["metrics_state"] = metric_fields(st)
    out["metrics"] = M.compute_metrics(st)

    # host_local_batch: each rank's own rows pass through; the global
    # batch is their gather; an uneven split raises.
    local = mesh_lib.host_local_batch(mesh, x[rows], np.arange(16)[rows])
    out["host_local"] = [mesh_lib.fetch(t) for t in local]
    try:
        mesh_lib.host_local_batch(mesh1, x[:2 + mesh_lib.rank()])
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)

    # Serving over every rank.
    spec = build_model("cnn0", a["hp"], (32, 32, 3), 2)
    pred = Predictor(spec, a["state"], batch_size=6,
                     compute_dtype=torch.float32, device="cpu", mesh=mesh)
    out["batch_size"] = pred.batch_size
    out["probs"] = pred.predict_probs(a["frames"])
    ds = FrameArrays(a["frames"], np.zeros(len(a["frames"]), np.int32),
                     [str(i) for i in range(len(a["frames"]))])
    out["dataset_probs"] = pred.predict_dataset(ds)

    # Streaming under the mesh (each rank decoding only its rows) against
    # the device cache under the same mesh.
    imgs, labels = a["train"]
    fits = []
    for cached in (False, True):
        train = FrameArrays(imgs[:24], labels[:24], [""] * 24)
        val = FrameArrays(imgs[24:], labels[24:], [""] * 8)
        if cached:
            train = DeviceCachedDataset(train, "cpu")
            val = DeviceCachedDataset(val, "cpu")
        best, hist = Trainer(spec, seed=3, mesh=mesh1, device="cpu").fit(
            train, val, batch_size=8, epochs=2, patience=10, verbose=False)
        fits.append((best, [(h.train, h.val) for h in hist]))
    out["fits"] = fits
    return out


def _dp_step(a, spec, mesh, aug, per_rank_bn=False):
    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.train.loop import Trainer

    tr = Trainer(spec, class_weight=CW, aug_config=aug, seed=0, mesh=mesh,
                 device="cpu")
    if per_rank_bn:
        # Batch norms on the rank's rows alone; dropout is 0 here.
        G.set_data_parallel(tr.module, None)
    tr.begin_phase(0, spec.phases[0], a["state"])
    rows = mesh_lib.batch_sharding(mesh, len(a["mask"]))
    metrics = M.init_metrics(2)
    loss = tr.train_step(torch.as_tensor(a["images"][rows]),
                         torch.as_tensor(a["labels"][rows]),
                         torch.as_tensor(a["mask"][rows]), metrics,
                         denom=float(a["mask"].sum()))
    total = loss.reshape(1).clone()
    mesh_lib.all_reduce_tensors([total], tr.data_group)
    M.reduce_metrics(metrics, tr.data_group)
    return {"state": tr.state(), "metrics": metric_fields(metrics),
            "loss": float(total[0]),
            "grads": {k: p.grad.clone() for k, p in
                      tr.module.named_parameters() if p.grad is not None}}


def case_data_parallel(a):
    """A cnn0 step with batch norms that train, on this world's ``(1,
    N)`` mesh: with dropout and augmentation; without (the JAX
    comparison); without, batch norms on each rank's rows alone."""
    from ab_line_classifier_torch.models import build_model

    mesh = mesh_lib.make_mesh(n_data=-1, n_trial=1, device="cpu")
    spec = build_model("cnn0", a["hp"], (32, 32, 3), 2)
    spec0 = build_model("cnn0", a["hp0"], (32, 32, 3), 2)
    return {"random": _dp_step(a, spec, mesh, a["aug"]),
            "plain": _dp_step(a, spec0, mesh, None),
            "per_rank_bn": _dp_step(a, spec0, mesh, None, per_rank_bn=True)}


def case_sharded_cache(a):
    """``tests/test_sharded_cache.py``'s cases at 4 ranks, ``(1, 4)``."""
    from ab_line_classifier_torch.data.pipeline import (
        DeviceCachedDataset, FrameArrays, ShardedDeviceCachedDataset,
        maybe_device_cache)
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer)
    from ab_line_classifier_torch.train.loop import Trainer

    mesh = mesh_lib.make_mesh(n_data=4, n_trial=1, device="cpu")
    frames, labels = a["frames"], a["labels"]
    ds = FrameArrays(frames, labels, [str(i) for i in range(len(labels))])
    out = {}
    sc = ShardedDeviceCachedDataset(ds, "cpu", mesh)
    out["shard"] = (tuple(sc.frames.shape), sc.frames.clone())
    rc = DeviceCachedDataset(ds, "cpu")
    same = []
    for shuffle in (False, True):
        for br, bs in zip(rc.batches(8, shuffle=shuffle, seed=3),
                          sc.batches(8, shuffle=shuffle, seed=3)):
            same.append(bs.images.dtype == torch.uint8
                        and torch.equal(br.images, bs.images)
                        and torch.equal(br.labels, bs.labels)
                        and np.array_equal(br.mask, bs.mask))
    out["batches_equal"] = same

    spec = build_model("cnn0", a["hp"], (32, 32, 3), 2)
    runs = []
    for cache in (rc, sc):
        best, hist = Trainer(spec, seed=0, mesh=mesh, device="cpu").fit(
            cache, cache, batch_size=16, epochs=2, patience=5,
            verbose=False)
        runs.append((best, [(h.train["loss"], h.val["loss"])
                            for h in hist]))
    out["fits"] = runs

    trial_runs = []
    for shard in (False, True):
        pt = ParallelFoldTrainer(spec, 2, class_weights=a["cls_w"], seed=0,
                                 mesh=mesh, device="cpu")
        best, hist = pt.fit(frames, labels, a["train_idx"], a["val_idx"],
                            batch_size=16, epochs=2, patience=4,
                            verbose=False, shard_dataset=shard)
        trial_runs.append((best, hist))
    out["trial_fits"] = trial_runs

    nbytes = len(ds) * 32 * 32 * 3
    kind = {}
    for label, mode, budget, m in (("fits", "auto", 2 * nbytes, mesh),
                                   ("aggregate", "auto", nbytes // 4, mesh),
                                   ("none", "auto", nbytes // 100, mesh),
                                   ("forced", True, nbytes // 4, mesh),
                                   ("no_mesh", "auto", nbytes // 4, None)):
        c = maybe_device_cache(ds, mode, device="cpu", budget=budget,
                               mesh=m)
        kind[label] = type(c).__name__
    out["tiers"] = kind
    return out


def case_trial_parallel(a):
    """On a ``(2, 2)`` mesh: one stacked step, a whole fit, a resumed fit,
    and the LR search through the experiment function."""
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.data.pipeline import FrameArrays
    from ab_line_classifier_torch.data.splits import FoldSet
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer)
    from ab_line_classifier_torch.train.experiment import (FoldSource,
                                                           lr_search_parallel)

    mesh = mesh_lib.make_mesh(n_data=2, n_trial=2, device="cpu")
    out = {}
    spec = build_model("cnn0", a["hp0"], (32, 32, 3), 2)
    pt = ParallelFoldTrainer(spec, 2, class_weights=a["cls_w"], seed=0,
                             mesh=mesh, device="cpu")
    t = pt.trials
    params, buffers = pt.init_stacked()
    with torch.no_grad():
        for part in (params, buffers):
            for k, v in part.items():
                v.copy_(a["stacked"][k][t])
    opt = pt.begin_phase(0, spec.phases[0], params)
    rows = mesh_lib.batch_sharding(mesh, a["mask"].shape[1])
    metrics = M.init_metrics(2, trials=pt.trials.stop - pt.trials.start)
    mask = torch.as_tensor(a["mask"])
    pt.train_step(params, buffers, opt,
                  torch.as_tensor(a["images"][t, rows]),
                  torch.as_tensor(a["labels"][t, rows]), mask[t, rows],
                  np.ones(1), np.ones(1), metrics, denom=mask[t].sum(-1))
    M.reduce_metrics(metrics, pt.data_group)
    out["step"] = pt._gather_trials(
        {"params": {k: v.detach() for k, v in params.items()},
         "buffers": buffers,
         "grads": {k: v.grad for k, v in params.items()
                   if v.grad is not None},
         "metrics": metric_fields(metrics)})
    out["trials"] = mesh_lib.fetch(torch.tensor([t.start]))

    spec = build_model("cnn0", a["hp"], (32, 32, 3), 2)

    def fit(epochs, **kw):
        return ParallelFoldTrainer(
            spec, 2, class_weights=a["cls_w"], aug_config=a["aug"], seed=3,
            mesh=mesh, device="cpu").fit(
                a["frames"], a["frame_labels"], a["train_idx"], a["val_idx"],
                batch_size=16, epochs=epochs, patience=10, verbose=False,
                **kw)

    out["fit"] = fit(2)
    ck = os.path.join(a["tmp"], f"ck_{mesh_lib.rank()}")
    fit(1, checkpoint_dir=ck)
    out["resumed"] = fit(2, checkpoint_dir=ck, resume=True)
    out["ck_on_rank"] = os.path.isfile(os.path.join(ck, "trial_state.pt"))
    out["ck_ranks"] = mesh_lib.fetch(torch.tensor([int(out["ck_on_rank"])]))

    cfg = Config(a["cfg"])
    n = len(a["frame_labels"])
    source = FoldSource(FrameArrays(a["frames"], a["frame_labels"],
                                    [str(i) for i in range(n)]),
                        FoldSet([a["train_idx"][0]], [a["val_idx"][0]],
                                [a["val_idx"][0]]))
    out["lr_search"] = lr_search_parallel(
        cfg, n_trials=4, verbose=False, device="cpu", source=source,
        mesh=mesh_lib.mesh_from_config(cfg, "cpu"))
    return out


CASES = {"mesh": case_mesh, "data_parallel": case_data_parallel,
         "sharded_cache": case_sharded_cache,
         "trial_parallel": case_trial_parallel}


def main():
    case, rank, world, port, inp, out = sys.argv[1:]
    torch.set_num_threads(1)
    mesh_lib.init_process_group(
        "cpu", init_method=f"tcp://127.0.0.1:{port}", world=int(world),
        rank_=int(rank), timeout=180)
    try:
        result = CASES[case](torch.load(inp, weights_only=False))
        leaked = {m for m in sys.modules
                  if m.split(".")[0] in ("jax", "conftest",
                                         "ab_line_classifier_tpu")}
        if leaked:
            raise RuntimeError(f"a rank imported {sorted(leaked)}")
        if int(rank) == 0:
            torch.save(result, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
