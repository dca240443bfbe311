"""The device mesh over process groups (port of the JAX package's
``parallel/mesh.py``).

The mesh has the JAX package's two logical axes:

* ``data`` -- the batch axis: each rank takes its rows of every batch, the
  parameters are replicated and the gradients are summed over the axis;
* ``trial`` -- the experiment axis: the folds of a cross-validation or the
  trials of a sweep are divided among its slices.

PyTorch runs one process per device (``torchrun`` sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), where JAX runs one process over every
local device. So the mesh is a ``torch.distributed`` ``DeviceMesh`` over
the ranks of the default process group, laid out ``(trial, data)`` in rank
order, and a layout (JAX's ``NamedSharding``) is the answer to "which rows,
or which trials, does this rank hold". The global batch, the mesh shape
and the results are the JAX package's; only the process count differs.
Without a process group (world size 1) there is no mesh, as the JAX
package has none on one device, and every function here is a no-op.

The collectives a rank runs: :func:`all_reduce_tensors` (one buffer per
dtype: the gradient sum), :func:`broadcast_tensors` (replicated state from
rank 0), :func:`all_gather_rows` (serving's and :func:`fetch`'s gather),
:func:`broadcast_object` (rank 0's host decisions: a run's name, its
records). Each takes the process group it runs over; ``None`` (an axis of
one rank, or no process group) makes it a no-op.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ab_line_classifier_torch import resolve_device

DATA_AXIS = "data"
TRIAL_AXIS = "trial"

# make_mesh's meshes, by (device type, trial, data), for the default
# process group under "world".
_MESHES: Dict = {}


def world_size() -> int:
    """The ranks of the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process writes the host-side files (checkpoints,
    tables, plots, tracker records): rank 0, or the only process."""
    return rank() == 0


def world_group():
    """The group of every rank (the default process group), or None
    without one."""
    return dist.group.WORLD if dist.is_initialized() else None


def backend_device(group=None) -> torch.device:
    """Where a collective of ``group`` takes host-side data (byte strings,
    counts): the current CUDA device under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_process_group(device, *, backend: Optional[str] = None,
                       init_method: str = "env://",
                       world: Optional[int] = None,
                       rank_: Optional[int] = None,
                       timeout: float = 1800.0) -> torch.device:
    """Start the default process group for this rank's ``device`` (a CUDA
    device is made current first): ``nccl`` on CUDA and ``gloo`` on the
    CPU, unless ``backend`` names one. ``init_method`` ``env://`` reads
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``; a
    ``tcp://host:port`` address takes ``world`` and ``rank_``. Returns the
    device."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {} if world is None else {"world_size": world, "rank": rank_}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return device


def init_from_env(device=None) -> Tuple[torch.device, bool]:
    """An entry point's device and process group from ``torchrun``'s
    environment: with ``WORLD_SIZE`` set, the rank's device is
    ``cuda:LOCAL_RANK`` (``device`` ``cpu`` keeps the CPU) and the group
    starts (:func:`init_process_group`); without it, ``device`` as given
    and no group. Returns ``(device, started)``: whoever started the
    group ends it (``torch.distributed.destroy_process_group``)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return resolve_device(device), False
    if device is None or torch.device(device).type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return init_process_group(device), True


def run_with_env_group(run, device=None):
    """``run(device)`` inside :func:`init_from_env`'s process group (the
    CLI entry points' wrapper), the group ended after it if it was started
    here."""
    device, started = init_from_env(device)
    try:
        return run(device)
    finally:
        if started:
            dist.destroy_process_group()


def make_mesh(n_data: int = -1, n_trial: int = 1, device=None):
    """A ``(trial, data)`` ``DeviceMesh`` over the default process group.
    ``n_data=-1`` puts every remaining rank on the data axis. The JAX
    package's checks raise ``ValueError``; one more: one process drives one
    device, so the mesh covers every rank (a rank left out would have
    nothing to run). ``device`` is this rank's (default: the current CUDA
    device under NCCL, else the CPU). Each shape is built once per default
    process group and returned again after."""
    n = world_size()
    if n_trial <= 0:
        n_trial = 1
    if n_data == -1:
        if n % n_trial:
            raise ValueError(f"{n} devices not divisible by trial={n_trial}")
        n_data = n // n_trial
    if n_trial * n_data > n:
        raise ValueError(
            f"mesh {n_trial}x{n_data} needs {n_trial * n_data} devices, "
            f"have {n}")
    if n_trial * n_data < n:
        raise ValueError(
            f"mesh {n_trial}x{n_data} leaves {n - n_trial * n_data} of {n} "
            f"processes out: with one process per device the mesh covers "
            f"every rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start one "
                           "(init_process_group, or torchrun's environment "
                           "through init_from_env)")
    from torch.distributed.device_mesh import init_device_mesh

    kind = torch.device(device).type if device is not None else (
        backend_device().type)
    # A DeviceMesh creates a process group per axis, and under NCCL each
    # holds a communicator and device buffers: build each shape once per
    # default group, so a sweep's runs share one mesh.
    world = dist.group.WORLD
    if _MESHES.get("world") is not world:
        _MESHES.clear()
        _MESHES["world"] = world
    key = (kind, n_trial, n_data)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(
            kind, (n_trial, n_data), mesh_dim_names=(TRIAL_AXIS, DATA_AXIS))
    return _MESHES[key]


def mesh_from_config(cfg, device=None):
    """The ``PARALLEL.MESH`` mesh of a config, or None at world size 1, or
    with no PARALLEL section, or where the shape is invalid (said so)."""
    pcfg = cfg.get("PARALLEL")
    if not pcfg or world_size() <= 1:
        return None
    mesh_cfg = pcfg.get("MESH", {}) or {}
    try:
        return make_mesh(int(mesh_cfg.get("DATA", -1)),
                         int(mesh_cfg.get("TRIAL", 1)), device=device)
    except ValueError as e:
        print(f"mesh config invalid ({e}); running single-device")
        return None


# -- the mesh's axes --------------------------------------------------------
def axis_size(mesh, axis: str) -> int:
    """The length of ``axis``; 1 without a mesh."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of the ranks that share this rank's other
    coordinate, or None where the axis has one rank (nothing to
    reduce)."""
    if axis_size(mesh, axis) <= 1:
        return None
    return mesh.get_group(axis)


def _rows(n: int, parts: int, idx: int) -> slice:
    if n % parts:
        raise ValueError(f"a batch of {n} does not divide evenly over "
                         f"{parts} devices")
    k = n // parts
    return slice(idx * k, (idx + 1) * k)


def batch_sharding(mesh, n: int) -> slice:
    """The rows of an ``n``-row batch this rank holds when the batch is
    sharded over the ``data`` axis (the ``trial`` axis replicates it)."""
    return _rows(n, axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS))


def full_batch_sharding(mesh, n: int) -> slice:
    """The rows this rank holds when the batch spreads over EVERY rank
    (trial x data flattened, in rank order): serving has no trial axis."""
    return _rows(n, 1 if mesh is None else mesh.size(), rank())


def trial_replicated(mesh, n_trials: int) -> slice:
    """The trials this rank holds when the leading trial axis shards over
    the ``trial`` axis; all of them where the axis does not divide
    ``n_trials`` (replicated)."""
    t = axis_size(mesh, TRIAL_AXIS)
    if n_trials % t:
        return slice(0, n_trials)
    return _rows(n_trials, t, axis_index(mesh, TRIAL_AXIS))


def shard_batch(mesh, *arrays):
    """Each array's rows of the ``data`` axis (all of it without a mesh)."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = tuple(a[batch_sharding(mesh, len(a))] for a in arrays)
    return out if len(out) > 1 else out[0]


def host_local_batch(mesh, *arrays):
    """This process's rows of a global batch, loaded by this process alone
    (a real pipeline reads different files per host): with one process
    per device they are already this rank's ``data``-axis shard, so they
    pass through as tensors; a rank whose row count differs from its data
    peers' raises."""
    out = tuple(torch.as_tensor(a) for a in arrays)
    group = axis_group(mesh, DATA_AXIS)
    if group is not None:
        counts = all_gather_rows(
            torch.tensor([len(out[0])], device=backend_device(group)), group)
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"data ranks hold {counts.tolist()} rows: the "
                             f"global batch must split evenly")
    return out if len(out) > 1 else out[0]


# -- collectives --------------------------------------------------------------
def _size(group) -> int:
    return 1 if group is None or not dist.is_initialized() else (
        dist.get_world_size(group))


def _buckets(tensors: Sequence[torch.Tensor]
             ) -> List[List[torch.Tensor]]:
    by: Dict[Tuple, List[torch.Tensor]] = {}
    for t in tensors:
        by.setdefault((t.dtype, t.device), []).append(t)
    return list(by.values())


def _flat_apply(tensors: Sequence[torch.Tensor], op) -> None:
    """``op`` on one flat buffer per dtype and device, copied back into
    the tensors (any strides)."""
    for ts in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view(t.shape))


@torch.no_grad()
def all_reduce_tensors(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum ``tensors`` in place over ``group``: one ``all_reduce`` of one
    flat buffer per dtype (the data-parallel gradient sum)."""
    if _size(group) > 1 and tensors:
        _flat_apply(tensors, lambda f: dist.all_reduce(f, group=group))


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], group,
                      src: int = 0) -> None:
    """Overwrite ``tensors`` in place with global rank ``src``'s: one
    ``broadcast`` per dtype over ``group``."""
    if _size(group) > 1 and tensors:
        _flat_apply(tensors, lambda f: dist.broadcast(f, src, group=group))


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank of ``group``."""
    n = _size(group)
    if n <= 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable host state: a run's name, the records
    it read) on every rank; ``obj`` itself without a process group."""
    if world_size() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0, device=backend_device())
    return box[0]


def fetch(x) -> np.ndarray:
    """Host-materialize a value sharded along dim 0 over every rank (the
    value itself without a process group) on EVERY rank, so host-side
    logic (early stopping, LR plateaus, history) runs identically
    everywhere."""
    t = torch.as_tensor(x)
    if world_size() > 1:
        t = all_gather_rows(t.to(backend_device()), world_group())
    return t.cpu().numpy()
