"""Input pipeline: frames table -> decoded uint8 batches (port of the JAX
package's ``data/pipeline.py``), and the device-resident cache.

* :class:`FrameDataset`: the host decodes JPEGs (the native libjpeg loader
  of ``data/native.py`` where it builds, else PIL) and resizes them to
  IMG_DIM with the same nearest index map as the device kernel, into
  static-shape uint8 batches with a validity mask, on a background thread;
  normalization runs on the device.
* :class:`FrameArrays`: frames already decoded, in host memory (no PIL
  or pandas); the same batches.
* :class:`DeviceCachedDataset`: the frames decoded once (or given as
  arrays) and kept on the device; an epoch is a table of row indices
  (:meth:`DeviceCachedDataset.epoch_index_table`) and a batch a gather.
  :func:`maybe_device_cache` takes the cache when the frames fit half the
  device's free memory, and says so when it does not.
* :class:`ShardedDeviceCachedDataset`: under a device mesh, the frames
  split over the ``data`` axis (rank r holds rows ``[r*S, (r+1)*S)``,
  :func:`shard_frames_over_data`), so D ranks hold D times one device's
  cache; a batch is :func:`sharded_gather`: each rank fills its own rows
  of a zeroed uint8 batch and one uint8 ``all_reduce`` completes it,
  exactly, since one rank supplies each row.

A graphed epoch (``train/graphed.py``, the JAX package's scanned epoch)
uploads the epoch's index and mask tables once and gathers each step's
batch from a device row of them (:meth:`DeviceCachedDataset.gather` of a
device tensor; the sharded cache's one ``all_reduce`` under NCCL is
captured with it). A streamed epoch's host batches go over through
pinned buffers without a synchronizing copy (:class:`PinnedStaging`),
one batch ahead of the step (:func:`drain_behind`).

Under a mesh every rank iterates the same epoch, and ``batches(rows=)``
hands it only its rows of each batch (the data-parallel trainer's and the
serving path's shard), decoded or gathered for those rows alone.

Every epoch, streamed or cached, uses the same row order
(``np.random.RandomState(seed)`` shuffle) and pads its last batch with
wraparound rows of that batch's own (mask 0: out of the loss and the
metrics, but real images in a training batch norm's statistics). PIL and
pandas are imported only where they are used, so training and serving run
where neither is installed.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ab_line_classifier_torch.ops.image import nearest_indices
from ab_line_classifier_torch.parallel import mesh as mesh_lib
from ab_line_classifier_torch.utils.profiling import annotate

FRAME_PATH = "Frame Path"
CLASS = "Class"


@dataclass
class Batch:
    """A static-shape host batch."""

    images: np.ndarray   # uint8 [B, H, W, 3]
    labels: np.ndarray   # int32 [B]
    mask: np.ndarray     # float32 [B]; 0 marks padding rows
    indices: np.ndarray  # int32 [B] row indices into the source table (-1 pad)


def decode_jpeg(path: str) -> np.ndarray:
    """Decode one image file to uint8 RGB HWC."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _resize_nearest_np(img: np.ndarray, out_hw: Tuple[int, int],
                       mode: str = "tf") -> np.ndarray:
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    return img[nearest_indices(h, oh, mode)][:, nearest_indices(w, ow, mode)]


class FrameDataset:
    """A frames table (a pandas DataFrame with the reference's columns
    ``Frame Path``, ``Class``, ...) bound to an image directory.

    ``use_native``: decode with the native loader (``data/native.py``)
    where it builds (None), always (True: raises with the build's message
    where it does not) or never (False: PIL). Both decode the same
    bytes."""

    def __init__(self, frames_df, frames_dir: str,
                 img_dim: Tuple[int, int] = (128, 128),
                 resize_mode: str = "tf",
                 use_native: Optional[bool] = None):
        self.df = frames_df.reset_index(drop=True)
        self.frames_dir = frames_dir
        self.img_dim = tuple(img_dim)
        self.resize_mode = resize_mode
        self._paths = [os.path.join(frames_dir, p)
                       for p in self.df[FRAME_PATH]]
        if use_native is not False:
            from ab_line_classifier_torch.data import native

            available = native.native_available()
            if use_native and not available:
                raise RuntimeError(f"use_native=True, but the native JPEG "
                                   f"loader is unavailable: "
                                   f"{native.build_error()}")
            use_native = available
        self.use_native = use_native

    def __len__(self) -> int:
        return len(self.df)

    @property
    def labels(self) -> np.ndarray:
        # Unlabeled tables (prediction-only use) get all-zero labels.
        if CLASS not in self.df.columns:
            return np.zeros(len(self.df), np.int32)
        return self.df[CLASS].to_numpy().astype(np.int32)

    @property
    def frame_paths(self) -> Sequence[str]:
        """Each row's ``Frame Path`` as the table gives it."""
        return [str(p) for p in self.df[FRAME_PATH]]

    def n_batches(self, batch_size: int, drop_remainder: bool = False) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else -(-n // batch_size)

    def take(self, rows: np.ndarray) -> "FrameDataset":
        """Rows ``rows`` of the table, in that order."""
        return FrameDataset(self.df.iloc[rows], self.frames_dir,
                            self.img_dim, self.resize_mode, self.use_native)

    def load_frame(self, row_idx: int) -> np.ndarray:
        img = decode_jpeg(self._paths[row_idx])
        return _resize_nearest_np(img, self.img_dim, self.resize_mode)

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every frame decoded into one uint8 ``[N, H, W, 3]`` array, and
        the labels."""
        h, w = self.img_dim
        images = np.zeros((len(self), h, w, 3), np.uint8)
        self._decode(np.arange(len(self)), images)
        return images, self.labels

    def _decode(self, rows: np.ndarray, out: np.ndarray) -> None:
        """Frames ``rows`` decoded into ``out[:len(rows)]``."""
        if self.use_native:
            from ab_line_classifier_torch.data import native

            native.decode_jpeg_batch([self._paths[int(r)] for r in rows],
                                     self.img_dim, self.resize_mode,
                                     out=out[:len(rows)])
            return
        for j, r in enumerate(rows):
            out[j] = self.load_frame(int(r))

    # ------------------------------------------------------------------
    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                prefetch: int = 2,
                rows: Optional[slice] = None) -> Iterator[Batch]:
        """Iterate static-shape batches, decoding on a background thread
        up to ``prefetch`` batches ahead: in table order, or shuffled by
        ``np.random.RandomState(seed)``; rows past the valid count of the
        last batch repeat that batch's own rows (mask 0), unless
        ``drop_remainder`` drops a partial last batch. ``rows`` (a slice of
        ``range(batch_size)``) yields only those rows of each batch, and
        decodes only them."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        if drop_remainder:
            order = order[: (len(order) // batch_size) * batch_size]
        all_labels = self.labels
        keep = slice(None) if rows is None else rows

        def make_batch(idxs: np.ndarray, n_valid: int) -> Batch:
            valid = idxs[:n_valid]
            # Wraparound rows repeat the batch's own rows.
            full = np.concatenate([valid, np.resize(valid,
                                                    batch_size - n_valid)])
            mask = (np.arange(batch_size) < n_valid).astype(np.float32)
            indices = np.where(mask > 0, full, -1).astype(np.int32)
            sel = full[keep]
            # Each distinct frame is decoded once and its repeats copied.
            uniq, inv = np.unique(sel, return_inverse=True)
            images = np.zeros((len(uniq),) + self.img_dim + (3,), np.uint8)
            self._decode(uniq, images)
            return Batch(images[inv.reshape(-1)],
                         all_labels[sel].astype(np.int32), mask[keep],
                         indices[keep])

        chunks = [(order[i:i + batch_size], len(order[i:i + batch_size]))
                  for i in range(0, len(order), batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that stays responsive to ``stop``, so an
            abandoned consumer never strands the producer thread."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for c, nv in chunks:
                    if stop.is_set() or not put_or_stop(make_batch(c, nv)):
                        return
            except Exception as e:  # surface decode errors to the consumer
                put_or_stop(e)
            finally:
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # unblock a mid-put producer promptly
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


@dataclass
class FrameArrays:
    """A frames table in array form, served from host memory: every frame
    decoded at ``img_dim``, uint8 ``[N, H, W, 3]``, its label and its
    ``Frame Path``. Built from arrays, so it needs no pandas or PIL; its
    batches are :meth:`FrameDataset.batches`' batches."""

    images: np.ndarray
    labels: np.ndarray
    frame_paths: Sequence[str]

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def img_dim(self) -> Tuple[int, int]:
        return tuple(self.images.shape[1:3])

    def take(self, rows: np.ndarray) -> "FrameArrays":
        """Rows ``rows``, in that order."""
        return FrameArrays(self.images[rows], np.asarray(self.labels)[rows],
                           [self.frame_paths[i] for i in rows])

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.images, np.asarray(self.labels, np.int32)

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                prefetch: int = 0,
                rows: Optional[slice] = None) -> Iterator[Batch]:
        del prefetch
        idx_tab, mask_tab = epoch_index_table(len(self), batch_size,
                                              shuffle=shuffle, seed=seed)
        nb = idx_tab.shape[0]
        if drop_remainder and len(self) % batch_size:
            nb -= 1
        labels = np.asarray(self.labels, np.int32)
        sel = slice(None) if rows is None else rows
        for idx, mask in zip(idx_tab[:nb, sel], mask_tab[:nb, sel]):
            yield Batch(self.images[idx], labels[idx], mask,
                        np.where(mask > 0, idx, -1).astype(np.int32))


def drain_behind(launched: Iterable, consume: Callable) -> None:
    """One-deep host/device pipelining: item k+1 is LAUNCHED (pulled from
    ``launched``, which issues its copy and compute) before item k is
    CONSUMED (its blocking readback), and the tail always flushes."""
    pending = None
    for item in launched:
        if pending is not None:
            consume(pending)
        pending = item
    if pending is not None:
        consume(pending)


class PinnedStaging:
    """Host arrays to ``device`` without a synchronizing copy: on CUDA each
    call's arrays go into one of ``slots`` pinned buffers, taken in turn,
    and over with ``non_blocking=True``; a buffer is refilled only after
    its previous copies have finished (an event recorded after them), so
    the host never overwrites bytes in flight and runs at most ``slots``
    copies ahead. On the CPU the arrays become tensors as they are.
    Spans: ``staging.wait`` (the slot's event) and ``staging.copy`` (the
    host copy into the pinned buffer and the upload's enqueue)."""

    def __init__(self, device, slots: int = 2):
        self.device = torch.device(device)
        self._slots = [([], None) for _ in range(slots)]
        self._next = 0

    def __call__(self, *arrays, out: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, ...]:
        """Each of ``arrays`` on the device: new tensors, or copied into
        ``out`` (device tensors of the arrays' shapes)."""
        host = [torch.as_tensor(a) for a in arrays]
        if self.device.type != "cuda":
            if out is None:
                return tuple(t.to(self.device) for t in host)
            for o, t in zip(out, host):
                o.copy_(t)
            return tuple(out)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        bufs, event = self._slots[i]
        if event is not None:
            with annotate("staging.wait"):
                event.synchronize()
        with annotate("staging.copy"):
            if [(b.shape, b.dtype) for b in bufs] != [(t.shape, t.dtype)
                                                      for t in host]:
                bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in host]
            for b, t in zip(bufs, host):
                b.copy_(t)
            if out is None:
                res = tuple(b.to(self.device, non_blocking=True)
                            for b in bufs)
            else:
                for o, b in zip(out, bufs):
                    o.copy_(b, non_blocking=True)
                res = tuple(out)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._slots[i] = (bufs, event)
        return res


def epoch_index_table(n: int, batch_size: int, *, shuffle: bool = False,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """One epoch of ``n`` rows as a ``[n_batches, batch_size]`` row-index
    table and validity mask: the order :meth:`FrameDataset.batches` uses,
    the last batch padded by cycling its own rows."""
    order = np.arange(n, dtype=np.int64)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    tail = order[(nb - 1) * batch_size:]
    idx = np.concatenate([order, np.resize(tail, pad)]) if pad else order
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return idx.reshape(nb, batch_size), mask.reshape(nb, batch_size)


class DeviceCachedDataset:
    """uint8 frames ``[N, H, W, 3]`` and int64 labels kept on ``device``;
    a batch is a gather of rows on the device, so after the decode the
    host moves no pixels. Build it from a :class:`FrameDataset` (decoded
    once) or a :class:`FrameArrays`, or from arrays (:meth:`from_arrays`,
    no pandas)."""

    def __init__(self, ds, device):
        images, labels = ds.load_all()
        self._init(images, labels, ds.img_dim, device, ds.frame_paths)

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray, device,
                    frame_paths: Optional[Sequence[str]] = None
                    ) -> "DeviceCachedDataset":
        """A cache of uint8 ``images`` ``[N, H, W, 3]`` and integer
        ``labels`` ``[N]``; ``frame_paths`` name the rows (default: their
        indices)."""
        self = cls.__new__(cls)
        self._init(np.asarray(images, np.uint8), np.asarray(labels),
                   tuple(images.shape[1:3]), device, frame_paths)
        return self

    def _init(self, images, labels, img_dim, device, frame_paths) -> None:
        self.device = torch.device(device)
        self.img_dim = tuple(img_dim)
        self.frames = torch.as_tensor(images).to(self.device)
        self.labels_dev = torch.as_tensor(
            labels.astype(np.int64)).to(self.device)
        self._labels = labels.astype(np.int32)
        self.frame_paths = (list(frame_paths) if frame_paths is not None
                            else [str(i) for i in range(len(labels))])

    def __len__(self) -> int:
        return len(self._labels)

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    def n_batches(self, batch_size: int, drop_remainder: bool = False) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else -(-n // batch_size)

    def epoch_index_table(self, batch_size: int, *, shuffle: bool = False,
                          seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        return epoch_index_table(len(self), batch_size, shuffle=shuffle,
                                 seed=seed)

    def gather(self, idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The frames and labels of rows ``idx``, on the device: ``idx`` of
        any shape (the trial-parallel trainer's ``[F, B]`` table) gives
        frames ``idx.shape + (H, W, 3)`` and labels ``idx.shape``, one
        gather each. ``idx`` may be a device tensor, a row of an epoch's
        table on the device (``train/graphed.py``): then nothing goes
        over from the host, and the gather can be captured (the JAX
        package's ``make_scan_gather``)."""
        rows = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        flat = rows.reshape(-1)
        return (self.frames.index_select(0, flat).view(
                    tuple(rows.shape) + tuple(self.frames.shape[1:])),
                self.labels_dev.index_select(0, flat).view(rows.shape))

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                prefetch: int = 0,
                rows: Optional[slice] = None) -> Iterator[Batch]:
        """:meth:`FrameDataset.batches`' batches, images and labels as
        device tensors; ``rows`` gathers only those rows of each."""
        del prefetch
        idx_tab, mask_tab = self.epoch_index_table(batch_size,
                                                   shuffle=shuffle, seed=seed)
        nb = idx_tab.shape[0]
        if drop_remainder and len(self) % batch_size:
            nb -= 1
        sel = slice(None) if rows is None else rows
        for idx, mask in zip(idx_tab[:nb], mask_tab[:nb]):
            images, labels = self.gather_rows(idx, rows)
            yield Batch(images, labels, mask[sel],
                        np.where(mask > 0, idx, -1).astype(np.int32)[sel])

    def gather_rows(self, idx: np.ndarray, rows: Optional[slice] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`gather` of the ``rows`` (a slice of the last axis) of
        ``idx``; all of it without ``rows``."""
        return self.gather(idx if rows is None else idx[..., rows])


def shard_frames_over_data(images: np.ndarray, mesh, device) -> torch.Tensor:
    """This rank's shard of a ``[N, ...]`` host array split over the
    mesh's ``data`` axis, on ``device``: rows ``[r*S, (r+1)*S)`` with ``S
    = ceil(N/D)``, zero rows padding the tail (never indexed)."""
    d = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    r = mesh_lib.axis_index(mesh, mesh_lib.DATA_AXIS)
    s = -(-len(images) // d)
    local = np.zeros((s,) + images.shape[1:], images.dtype)
    part = images[r * s:(r + 1) * s]
    local[:len(part)] = part
    return torch.as_tensor(local).to(device)


def sharded_gather(local: torch.Tensor, idx, group) -> torch.Tensor:
    """Rows ``idx`` (any integer shape, global row numbers) of a frame
    store split over ``group`` (this rank holding ``local``, its ``[S,
    ...]`` shard, rank r of the group rows ``[r*S, (r+1)*S)``): each rank
    fills the rows it owns of a zeroed batch, and one ``all_reduce`` SUM
    in the frames' dtype completes it on every rank. Exact, uint8
    included: one rank supplies each row, the others add zeros."""
    s = local.shape[0]
    r = dist.get_rank(group)
    rows = torch.as_tensor(idx, dtype=torch.int64).to(local.device)
    rel = rows.reshape(-1) - r * s
    owned = (rel >= 0) & (rel < s)
    out = local.index_select(0, rel.clamp(0, s - 1))
    out *= owned.view((-1,) + (1,) * (local.ndim - 1)).to(out.dtype)
    dist.all_reduce(out, group=group)
    return out.view(tuple(rows.shape) + tuple(local.shape[1:]))


class ShardedDeviceCachedDataset(DeviceCachedDataset):
    """A device cache whose uint8 frames split over the mesh's ``data``
    axis: D ranks hold D times one device's cache, each its 1/D
    (:func:`shard_frames_over_data`); the labels (4 bytes a frame) are
    held whole. A batch is :func:`sharded_gather` (one uint8 ``all_reduce``
    over the data group), bit-equal to the replicated cache's; every data
    rank gathers the same batch, together."""

    def __init__(self, ds, device, mesh):
        images, labels = ds.load_all()
        self._init_sharded(images, labels, ds.img_dim, device, mesh,
                           ds.frame_paths)

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray, device,
                    mesh, frame_paths: Optional[Sequence[str]] = None
                    ) -> "ShardedDeviceCachedDataset":
        self = cls.__new__(cls)
        self._init_sharded(np.asarray(images, np.uint8), np.asarray(labels),
                           tuple(images.shape[1:3]), device, mesh,
                           frame_paths)
        return self

    def _init_sharded(self, images, labels, img_dim, device, mesh,
                      frame_paths) -> None:
        if mesh is None:
            raise ValueError("ShardedDeviceCachedDataset requires a mesh")
        self._init(images[:0], labels, img_dim, device, frame_paths)
        self.group = mesh_lib.axis_group(mesh, mesh_lib.DATA_AXIS)
        self.frames = shard_frames_over_data(images, mesh, self.device)

    def gather(self, idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        labels = self.labels_dev.index_select(0, rows.reshape(-1))
        return (sharded_gather(self.frames, rows, self.group),
                labels.view(rows.shape))

    def gather_rows(self, idx: np.ndarray, rows: Optional[slice] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole of ``idx`` gathered (the collective every data rank
        joins), then its ``rows``."""
        images, labels = self.gather(idx)
        if rows is None:
            return images, labels
        lead = (slice(None),) * (labels.ndim - 1) + (rows,)
        return images[lead], labels[lead]


#: Device-cache budget where the device reports no free memory (the CPU).
DEVICE_CACHE_BYTES = 2 << 30
#: Share of the device's free memory the cache may take; the rest stays
#: for parameters, optimizer state and activations.
_FREE_FRACTION = 0.5


def device_cache_budget(device) -> int:
    """Half the free memory of a CUDA ``device``
    (``torch.cuda.mem_get_info``), else :data:`DEVICE_CACHE_BYTES`."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * _FREE_FRACTION)
    return DEVICE_CACHE_BYTES


def maybe_device_cache(ds, mode="auto", *, device,
                       budget: Optional[int] = None, mesh=None):
    """``ds`` (a :class:`FrameDataset` or :class:`FrameArrays`) cached on
    ``device`` when ``mode`` is True or 'auto', by the JAX package's tiers
    (``budget``, default :func:`device_cache_budget`, is per device):

    * its decoded frames fit ``budget`` -> :class:`DeviceCachedDataset`
      (every rank holds them all);
    * they exceed it, the mesh's ``data`` axis has D > 1 ranks and they fit
      ``budget * D`` -> :class:`ShardedDeviceCachedDataset`;
    * else, under 'auto', ``ds`` itself, its batches going over from the
      host (decoded from disk, or from host memory), said so.

    Forced caching (True) beyond one device's budget takes the sharded
    tier where there is one."""
    if mode is False or mode is None or len(ds) == 0:
        return ds
    if budget is None:
        budget = device_cache_budget(device)
    h, w = ds.img_dim
    nbytes = len(ds) * h * w * 3
    n_data = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    sharded = nbytes > budget and n_data > 1
    if mode == "auto" and nbytes > budget and not (
            sharded and nbytes <= budget * n_data):
        print(f"(device cache not taken: {len(ds)} frames need {nbytes} "
              f"bytes, over the {budget}-byte budget"
              + (f" times {n_data} data ranks" if n_data > 1 else "")
              + "; batches go over from the host)")
        return ds
    if sharded:
        return ShardedDeviceCachedDataset(ds, device, mesh)
    return DeviceCachedDataset(ds, device)
