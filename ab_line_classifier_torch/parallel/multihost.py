"""Multi-process execution (port of the JAX package's
``parallel/multihost.py``): a process group over several processes, one
data-parallel train step and one trial-parallel epoch over meshes that
span them, runnable as a subprocess per rank.

JAX starts one process per host (``jax.distributed.initialize``) over all
its local devices; PyTorch starts one per device. So where the JAX dryrun
runs two processes of four virtual devices, this one runs N processes of
one device each, and holds them against one process. As every entry
point of the port, each runs on CUDA (rank r on ``cuda:r`` modulo the
host's devices, under NCCL) unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``: gloo); ``--backend`` names another.

Surfaces:

* :func:`dryrun_multihost` -- in a fresh process per rank: start the group
  (``init_process_group`` with a timeout), run one data-parallel cnn0 step
  over a ``(1, N)`` mesh and one trial-parallel epoch over ``(N, 1)``,
  check that the resume file written on rank 0 alone reaches every rank,
  and have rank 0 save the results;
* :func:`spawn_ranks` -- the launcher: a free port from a bind to port 0,
  one subprocess per rank, ONE shared deadline for all of them, and on a
  timeout or failure every survivor killed and the stderr tails raised;
* :func:`spawn_dryrun_pair` -- two ranks of :func:`dryrun_multihost`;
* :func:`dryrun_multichip` -- the port's counterpart of the JAX package's
  ``__graft_entry__.dryrun_multichip``: N ranks train, evaluate, serve
  and run the trial axis over a ``(trial, data)`` mesh, then the pair's
  parity with one process;
* ``python -m ab_line_classifier_torch.parallel.multihost`` -- the rank
  program.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ab_line_classifier_torch import resolve_device

# Tiny but real: conv + BN + dropout + dense, the whole train step.
_HP = {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 1e-4, "NODES_DENSE0": 8,
       "KERNEL_SIZE": 3, "STRIDES": 2, "MAXPOOL_SIZE": 2, "BLOCKS": 1,
       "INIT_FILTERS": 4, "FILTER_EXP_BASE": 2}
_IMG = (16, 16)
_BATCH = 16  # global batch, split over the data axis
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def global_batch(n_classes: int = 2):
    """The deterministic global batch every rank agrees on."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (_BATCH, *_IMG, 3)).astype(np.uint8)
    labels = rng.randint(0, n_classes, _BATCH).astype(np.int32)
    mask = np.ones((_BATCH,), np.float32)
    return images, labels, mask


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: ``device`` resolved (CUDA unless the
    caller asks for the CPU), a CUDA device without an index being the
    rank's own, ``cuda:rank`` modulo the host's devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def one_step_params(mesh, device=None) -> List[np.ndarray]:
    """A tiny cnn0's state (parameters and batch-norm statistics, host
    arrays) after ONE data-parallel step over ``mesh`` (None: one
    process), each rank loading only its rows of :func:`global_batch`.
    Every rank calls it with the same mesh."""
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.parallel import mesh as mesh_lib
    from ab_line_classifier_torch.train.loop import Trainer

    spec = build_model("cnn0", _HP, _IMG + (3,), 2)
    trainer = Trainer(spec, seed=0, mesh=mesh, device=device)
    trainer.begin_phase(0, spec.phases[0])
    images, labels, mask = global_batch()
    # A real pipeline reads different files per rank: each rank loads
    # only its rows.
    rows = mesh_lib.batch_sharding(mesh, _BATCH)
    batch = mesh_lib.host_local_batch(mesh, images[rows], labels[rows],
                                      mask[rows])
    trainer.train_step(*(t.to(trainer.device) for t in batch),
                       M.init_metrics(2, device=trainer.device),
                       denom=float(mask.sum()))
    return [v.numpy() for v in trainer.state().values()]


def one_epoch_trial_parallel(mesh, n_trials: int,
                             device=None) -> np.ndarray:
    """One trial-parallel epoch of ``n_trials`` tiny cnn0 trials over
    ``mesh`` (None: one process), the trials on the ``trial`` axis and each
    trial's batch on the ``data`` axis; the per-trial validation losses,
    on every rank."""
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer)

    spec = build_model("cnn0", _HP, _IMG + (3,), 2)
    pt = ParallelFoldTrainer(
        spec, n_trials, class_weights=np.ones((n_trials, 2), np.float32),
        seed=0, device=device, mesh=mesh)
    images, labels, _ = global_batch()
    idx = [np.arange(_BATCH) for _ in range(n_trials)]
    _, hist = pt.fit(images, labels, idx, idx, batch_size=_BATCH, epochs=1,
                     verbose=False)
    return np.asarray(hist[-1]["val_loss"])


def dryrun_multihost(process_id: int, num_processes: int, coordinator: str,
                     out_path: Optional[str] = None, *,
                     backend: Optional[str] = None, device=None,
                     timeout: float = 300.0) -> None:
    """Start the process group (rank ``process_id`` of ``num_processes``,
    ``coordinator`` a ``host:port``) and run one data-parallel step, one
    trial-parallel epoch and the resume sync; rank 0 saves the results to
    ``out_path`` (``.npz``). Runs in a fresh process per rank."""
    import torch.distributed as dist

    from ab_line_classifier_torch.parallel import mesh as mesh_lib
    from ab_line_classifier_torch.utils.resume import load_resume, save_resume

    device = mesh_lib.init_process_group(
        rank_device(device, process_id), backend=backend, init_method=f"tcp://{coordinator}",
        world=num_processes, rank_=process_id, timeout=timeout)
    try:
        if mesh_lib.world_size() != num_processes:
            raise RuntimeError(f"world size {mesh_lib.world_size()}, "
                               f"expected {num_processes}")
        mesh = mesh_lib.make_mesh(n_data=num_processes, n_trial=1,
                                  device=device)
        leaves = one_step_params(mesh, device)
        # The JAX package's pod topology: trial = the process axis.
        mesh_t = mesh_lib.make_mesh(n_data=1, n_trial=num_processes,
                                    device=device)
        val_loss = one_epoch_trial_parallel(mesh_t, num_processes, device)

        # A checkpoint in a directory only rank 0 has (host-local
        # directories, no shared filesystem), loaded by every rank:
        # load_resume must hand rank 0's bytes to all.
        ckpt_dir = (tempfile.mkdtemp(prefix="mh_resume_") if process_id == 0
                    else os.path.join(tempfile.gettempdir(),
                                      "mh_resume_absent_here"))
        save_resume(ckpt_dir, "probe.pt",
                    {"w": torch.arange(4, dtype=torch.float32)},
                    {"epoch": 7})
        loaded = load_resume(ckpt_dir, "probe.pt")
        if loaded is None or loaded[1]["epoch"] != 7 or not torch.equal(
                loaded[0]["w"], torch.arange(4, dtype=torch.float32)):
            raise RuntimeError("resume sync lost rank 0's checkpoint")
        if out_path and process_id == 0:
            np.savez(out_path, *leaves, trial_val_loss=val_loss)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (a bind to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(extra: Optional[dict] = None) -> dict:
    """The environment of a rank process: this one's, the repository
    PREPENDED to ``PYTHONPATH`` (never overwritten), one intra-op thread
    (N ranks share the host's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra or {})
    return env


def spawn_ranks(argv: Callable[[int, int], Sequence[str]], n: int, *,
                timeout: float = 600.0, env: Optional[dict] = None,
                cwd: str = REPO_ROOT) -> List[str]:
    """Run ``argv(rank, port)`` for ranks ``0..n-1`` as subprocesses (the
    port free, for the group's address) and return their standard
    outputs. ONE deadline for all of them: waiting on each with its own
    timeout would grant a later rank a fresh budget. On the deadline
    every rank still running is killed and the stderr tails are raised;
    a rank that fails raises its tail, the others killed."""
    port = free_port()
    procs = [subprocess.Popen(list(argv(r, port)), env=env or rank_env(),
                              cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(0.0, deadline - time.monotonic())))
            if p.returncode != 0:
                break
    except subprocess.TimeoutExpired:
        raise RuntimeError(
            f"{n} ranks timed out after {timeout}s; stderr tails:\n"
            + "\n---\n".join(_kill_all(procs))) from None
    failed = [r for r, p in enumerate(procs[:len(outs)]) if p.returncode]
    if failed:
        tails = _kill_all(procs)
        r = failed[0]
        raise RuntimeError(
            f"rank {r} failed (rc={procs[r].returncode}):\n"
            f"{outs[r][1].decode(errors='replace')[-3000:]}\n--- other "
            f"ranks:\n" + "\n---\n".join(t for i, t in enumerate(tails)
                                          if i != r))
    return [o.decode(errors="replace") for o, _ in outs]


def _kill_all(procs) -> List[str]:
    """Kill every process still running; each one's stderr tail."""
    tails = []
    for p in procs:
        if p.poll() is None:
            p.kill()
        try:
            _, se = p.communicate(timeout=30)
        except (subprocess.TimeoutExpired, ValueError):
            se = b""
        tails.append((se or b"").decode(errors="replace")[-2000:])
    return tails


def _device_args(device, backend=None) -> List[str]:
    """A rank program's ``--device``/``--backend`` flags: only those the
    caller gave (the rank resolves the rest as every entry point does)."""
    return ((["--device", str(device)] if device is not None else [])
            + (["--backend", backend] if backend is not None else []))


def spawn_dryrun_pair(out_path: str, *, timeout: float = 600.0,
                      backend: Optional[str] = None, device=None):
    """Two ranks of :func:`dryrun_multihost` (one subprocess each); the
    ``.npz`` rank 0 wrote."""
    def argv(r, port):
        return [sys.executable, "-m",
                "ab_line_classifier_torch.parallel.multihost",
                "--process-id", str(r), "--num-processes", "2",
                "--coordinator", f"127.0.0.1:{port}", "--out", out_path,
                "--timeout", str(int(timeout))] + _device_args(device,
                                                               backend)

    spawn_ranks(argv, 2, timeout=timeout)
    return np.load(out_path)


def _dryrun_rank(n: int, rank: int, port: int, out_path: str,
                 device: str) -> None:
    """Rank ``rank`` of :func:`dryrun_multichip`: a ``(trial, data)`` mesh
    of ``n`` (trial 2 when ``n`` is even), cutoffvgg16 at 32x32 through one
    data-parallel step of each phase (augmentation, bf16) and an eval
    step, serving over every rank, a trial-parallel epoch with its frames
    whole and split over the data axis (bit-equal); rank 0 saves the
    results."""
    import torch.distributed as dist

    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.parallel import mesh as mesh_lib
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer)
    from ab_line_classifier_torch.predict.predict import Predictor
    from ab_line_classifier_torch.train.loop import Trainer

    dev = mesh_lib.init_process_group(
        rank_device(device, rank), init_method=f"tcp://127.0.0.1:{port}",
        world=n,
        rank_=rank, timeout=300)
    try:
        n_trial = 2 if n % 2 == 0 and n > 1 else 1
        mesh = mesh_lib.make_mesh(n_data=-1, n_trial=n_trial, device=dev)
        n_data = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
        hp = {"LR_EXTRACT": 3e-4, "LR_FINETUNE": 9.3e-6, "DROPOUT": 0.45,
              "CUTOFF_LAYER": 10, "FINETUNE_LAYER": 7, "EXTRACT_EPOCHS": 1}
        spec = build_model("cutoffvgg16", hp, (32, 32, 3), 2,
                           total_epochs=2)
        trainer = Trainer(spec, class_weight={0: 0.7, 1: 1.6},
                          aug_config={"ZOOM_RANGE": 0.1,
                                      "HORIZONTAL_FLIP": True,
                                      "WIDTH_SHIFT_RANGE": 0.1,
                                      "HEIGHT_SHIFT_RANGE": 0.1,
                                      "ROTATION_RANGE": 10,
                                      "BRIGHTNESS_RANGE": 0.2},
                          seed=0, mesh=mesh, device=dev,
                          compute_dtype=torch.bfloat16)
        batch = 2 * n
        rng = np.random.RandomState(0)
        images = rng.randint(0, 256, (batch, 32, 32, 3)).astype(np.uint8)
        labels = rng.randint(0, 2, batch).astype(np.int32)
        mask = np.ones((batch,), np.float32)
        local = [torch.as_tensor(a).to(dev) for a in
                 mesh_lib.shard_batch(mesh, images, labels, mask)]
        out = {}
        for phase_idx, phase in enumerate(spec.phases):
            trainer.begin_phase(phase_idx, phase)
            metrics = M.init_metrics(2, device=dev)
            trainer.train_step(*local, metrics, denom=float(batch))
            M.reduce_metrics(metrics, trainer.data_group)
            out[f"loss_{phase.name}"] = M.compute_metrics(metrics)["loss"]
        metrics = M.init_metrics(2, device=dev)
        trainer.eval_step(*local, metrics)
        M.reduce_metrics(metrics, trainer.data_group)
        out["eval_loss"] = M.compute_metrics(metrics)["loss"]
        pred = Predictor(spec, trainer.state(), batch_size=batch,
                         compute_dtype=torch.bfloat16, device=dev, mesh=mesh)
        out["probs"] = pred.predict_probs(images)
        if n_trial > 1:
            hp2 = dict(_HP, L2_LAMBDA=0.0)
            spec2 = build_model("cnn0", hp2, (32, 32, 3), 2)
            idx = [np.arange(batch) for _ in range(n_trial)]
            losses = []
            for shard in (False, True) if n_data > 1 else (False,):
                pt = ParallelFoldTrainer(
                    spec2, n_trial,
                    class_weights=np.ones((n_trial, 2), np.float32),
                    mesh=mesh, seed=0, device=dev)
                _, hist = pt.fit(images, labels, idx, idx, batch_size=batch,
                                 epochs=1, verbose=False,
                                 shard_dataset=shard)
                losses.append(np.asarray(hist[-1]["val_loss"]))
            if any(not np.array_equal(losses[0], v) for v in losses[1:]):
                raise RuntimeError(f"sharded frame store's val losses "
                                   f"{losses[1]} != replicated {losses[0]}")
            out["trial_val_loss"] = losses[0]
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 600.0) -> None:
    """The full training, eval, serving and trial-axis programs over an
    ``n_devices``-rank mesh (N processes, one device each: CUDA unless
    ``device`` is ``"cpu"``), one
    step each on tiny shapes, then the two-rank dryrun's parity with one
    process. Raises on any failure."""
    out = os.path.join(tempfile.mkdtemp(prefix="mc_dryrun_"), "mc.npz")

    def argv(r, port):
        return [sys.executable, "-m",
                "ab_line_classifier_torch.parallel.multihost",
                "--multichip", str(n_devices), "--process-id", str(r),
                "--coordinator", f"127.0.0.1:{port}", "--out", out
                ] + _device_args(device)

    spawn_ranks(argv, n_devices, timeout=timeout)
    res = np.load(out)
    if res["probs"].shape != (2 * n_devices, 2) or not np.all(
            np.isfinite(res["probs"])):
        raise RuntimeError(f"sharded serving gave {res['probs'].shape}")
    print(f"dryrun_multichip({n_devices}): losses "
          f"{[float(res[k]) for k in res.files if 'loss_' in k]}, eval "
          f"{float(res['eval_loss']):.4f}, served {res['probs'].shape}"
          + (f", trial val_loss {res['trial_val_loss']}"
             if "trial_val_loss" in res.files else ""))
    if n_devices >= 2:
        pair = spawn_dryrun_pair(
            os.path.join(os.path.dirname(out), "pair.npz"), device=device,
            timeout=timeout)
        single = one_step_params(None, device)
        multi = [pair[k] for k in pair.files if k != "trial_val_loss"]
        for m, s in zip(multi, single):
            np.testing.assert_allclose(m, s, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            pair["trial_val_loss"], one_epoch_trial_parallel(None, 2, device),
            rtol=1e-5, atol=1e-6)
        print("multihost parity ok (2 processes == one process)")
    print(f"dryrun_multichip({n_devices}) OK")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--out", default=None)
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on CUDA, else gloo)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: rank r on cuda:r) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--multichip", type=int, default=0,
                    help="run rank --process-id of dryrun_multichip(N)")
    args = ap.parse_args()
    if args.multichip:
        _dryrun_rank(args.multichip, args.process_id,
                     int(args.coordinator.rsplit(":", 1)[1]), args.out,
                     args.device)
        return
    dryrun_multihost(args.process_id, args.num_processes, args.coordinator,
                     out_path=args.out, backend=args.backend,
                     device=args.device, timeout=args.timeout)


if __name__ == "__main__":
    main()
