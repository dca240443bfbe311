"""Input pipeline: frames table -> decoded uint8 batches (port of the PIL
path of the JAX package's ``data/pipeline.py``), and the device-resident
cache.

* :class:`FrameDataset`: the host decodes JPEGs (PIL) and resizes them to
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

Every epoch, streamed or cached, uses the same row order
(``np.random.RandomState(seed)`` shuffle) and pads its last batch with
wraparound rows of that batch's own (mask 0: out of the loss and the
metrics, but real images in a training batch norm's statistics). PIL and
pandas are imported only where they are used, so training and serving run
where neither is installed. The native ctypes loader comes with a later
slice of the port.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ab_line_classifier_torch.ops.image import nearest_indices

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
    ``Frame Path``, ``Class``, ...) bound to an image directory."""

    def __init__(self, frames_df, frames_dir: str,
                 img_dim: Tuple[int, int] = (128, 128),
                 resize_mode: str = "tf"):
        self.df = frames_df.reset_index(drop=True)
        self.frames_dir = frames_dir
        self.img_dim = tuple(img_dim)
        self.resize_mode = resize_mode
        self._paths = [os.path.join(frames_dir, p)
                       for p in self.df[FRAME_PATH]]

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
                            self.img_dim, self.resize_mode)

    def load_frame(self, row_idx: int) -> np.ndarray:
        img = decode_jpeg(self._paths[row_idx])
        return _resize_nearest_np(img, self.img_dim, self.resize_mode)

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every frame decoded into one uint8 ``[N, H, W, 3]`` array, and
        the labels."""
        h, w = self.img_dim
        images = np.zeros((len(self), h, w, 3), np.uint8)
        for i in range(len(self)):
            images[i] = self.load_frame(i)
        return images, self.labels

    # ------------------------------------------------------------------
    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                prefetch: int = 2) -> Iterator[Batch]:
        """Iterate static-shape batches, decoding on a background thread
        up to ``prefetch`` batches ahead: in table order, or shuffled by
        ``np.random.RandomState(seed)``; rows past the valid count of the
        last batch repeat that batch's own rows (mask 0), unless
        ``drop_remainder`` drops a partial last batch."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        if drop_remainder:
            order = order[: (len(order) // batch_size) * batch_size]
        all_labels = self.labels

        def make_batch(idxs: np.ndarray, n_valid: int) -> Batch:
            h, w = self.img_dim
            images = np.zeros((batch_size, h, w, 3), np.uint8)
            labels = np.zeros((batch_size,), np.int32)
            mask = np.zeros((batch_size,), np.float32)
            indices = np.full((batch_size,), -1, np.int32)
            valid = idxs[:n_valid]
            for j, ri in enumerate(valid):
                images[j] = self.load_frame(int(ri))
                labels[j] = all_labels[ri]
            for j in range(n_valid, batch_size):
                src = (j - n_valid) % n_valid
                images[j] = images[src]
                labels[j] = labels[src]
            mask[:n_valid] = 1.0
            indices[:n_valid] = valid
            return Batch(images, labels, mask, indices)

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
                prefetch: int = 0) -> Iterator[Batch]:
        del prefetch
        idx_tab, mask_tab = epoch_index_table(len(self), batch_size,
                                              shuffle=shuffle, seed=seed)
        nb = idx_tab.shape[0]
        if drop_remainder and len(self) % batch_size:
            nb -= 1
        labels = np.asarray(self.labels, np.int32)
        for idx, mask in zip(idx_tab[:nb], mask_tab[:nb]):
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
        gather each."""
        rows = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        flat = rows.reshape(-1)
        return (self.frames.index_select(0, flat).view(
                    tuple(rows.shape) + tuple(self.frames.shape[1:])),
                self.labels_dev.index_select(0, flat).view(rows.shape))

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                prefetch: int = 0) -> Iterator[Batch]:
        """:meth:`FrameDataset.batches`' batches, images and labels as
        device tensors."""
        del prefetch
        idx_tab, mask_tab = self.epoch_index_table(batch_size,
                                                   shuffle=shuffle, seed=seed)
        nb = idx_tab.shape[0]
        if drop_remainder and len(self) % batch_size:
            nb -= 1
        for b in range(nb):
            idx, mask = idx_tab[b], mask_tab[b]
            images, labels = self.gather(idx)
            yield Batch(images, labels, mask,
                        np.where(mask > 0, idx, -1).astype(np.int32))


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
                       budget: Optional[int] = None):
    """``ds`` (a :class:`FrameDataset` or :class:`FrameArrays`) as a
    :class:`DeviceCachedDataset` on ``device`` when ``mode`` is True, or
    'auto' and its decoded frames fit ``budget`` (default
    :func:`device_cache_budget`); else ``ds`` itself, its batches going over
    from the host (decoded from disk, or from host memory). Says why when
    the cache is not taken."""
    if mode is False or mode is None or len(ds) == 0:
        return ds
    if budget is None:
        budget = device_cache_budget(device)
    h, w = ds.img_dim
    nbytes = len(ds) * h * w * 3
    if mode == "auto" and nbytes > budget:
        print(f"(device cache not taken: {len(ds)} frames need {nbytes} "
              f"bytes, over the {budget}-byte budget; batches go over from "
              f"the host)")
        return ds
    return DeviceCachedDataset(ds, device)
