"""Host-side input pipeline: frames table -> decoded uint8 batches (port of
the PIL path of the JAX package's ``data/pipeline.py``).

The host decodes JPEGs (PIL) and resizes them to IMG_DIM with the same
nearest index map as the device kernel, into static-shape uint8 batches
with a validity mask, on a background thread; normalization runs on the
device. PIL and pandas are imported only where they are used, so the
serving path runs where neither is installed. The native ctypes loader
comes with a later slice of the port.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np

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

    def load_frame(self, row_idx: int) -> np.ndarray:
        img = decode_jpeg(self._paths[row_idx])
        return _resize_nearest_np(img, self.img_dim, self.resize_mode)

    # ------------------------------------------------------------------
    def batches(self, batch_size: int, *,
                prefetch: int = 2) -> Iterator[Batch]:
        """Iterate static-shape batches in table order, decoding on a
        background thread up to ``prefetch`` batches ahead. Rows past the
        valid count of the last batch repeat that batch's own rows
        (mask 0). Shuffled and drop-remainder epochs come with training."""
        order = np.arange(len(self))
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
