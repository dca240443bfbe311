"""Retrospective dataset creation: the abstract ETL pipeline (port of the
JAX package's ``data/dataset_creator.py``).

``create_dataset()`` chains ``query_to_df -> database_pull -> auto_mask ->
build_dataset``; the base class owns the clip pull and the auto-masking
stage, subclasses supply the query and the final table build.

As in the JAX package, downloads go through a swappable ``fetch_fn(url,
out_path)`` (default: stdlib ``urllib``), so the pipeline runs without a
network. The clips table is read without pandas (``utils/tables.py``).
Auto-masking runs the port's batched ``UnetSegmentation`` on the creator's
device: ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import logging
import os
import urllib.error
import urllib.request
from abc import ABC, abstractmethod
from typing import Callable, Dict, Optional

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.data.auto_masking import UnetSegmentation
from ab_line_classifier_torch.utils.tables import Table, read_table

logging.basicConfig(format="[%(levelname)s] %(message)s", level=logging.INFO)


def _default_fetch(url: str, out_path: str) -> None:
    urllib.request.urlretrieve(url, out_path)


class DatasetCreator(ABC):
    """Abstract base of retrospective dataset creation (reference
    ``dataset_creator.py:17-42``)."""

    def __init__(self, cfg,
                 fetch_fn: Optional[Callable[[str, str], None]] = None,
                 device=None):
        self.cfg = cfg
        self.fetch_fn = fetch_fn or _default_fetch
        self.device = resolve_device(device)

    def create_dataset(self) -> None:
        logging.info("Running query to df process...")
        self.query_to_df()
        logging.info("Running database pull process...")
        self.database_pull()
        logging.info("Running auto-masking process...")
        self.auto_mask()
        logging.info("Performing final dataset build...")
        self.build_dataset()

    @abstractmethod
    def query_to_df(self) -> Table:
        ...

    @abstractmethod
    def build_dataset(self) -> None:
        ...

    def database_pull(self) -> Dict[str, int]:
        """Pull raw clips through the clips table's ``s3_path`` links:
        ``{id}.mp4`` per row, each fetched to a ``.part`` name and renamed
        when complete, so a failed transfer never leaves a truncated clip
        that a later stage would ingest. A ``URLError`` (an HTTP error, a
        reset connection, a short read) is counted, not raised, and its
        ``.part`` removed. Returns the counts by error text."""
        output_folder = self.cfg["PATHS"]["RAW_CLIPS"]
        table = read_table(self.cfg["PATHS"]["CLIPS_TABLE"])
        os.makedirs(output_folder, exist_ok=True)

        links, clip_ids = table["s3_path"], table["id"]
        logging.info("Fetching clips...")
        warning_counts: Dict[str, int] = {}
        for link, clip_id in zip(links, clip_ids):
            dest = os.path.join(output_folder, f"{clip_id}.mp4")
            part = dest + ".part"
            try:
                self.fetch_fn(link, part)
                os.replace(part, dest)
            except urllib.error.URLError as e:
                if os.path.exists(part):
                    os.remove(part)
                key = str(e)
                warning_counts[key] = warning_counts.get(key, 0) + 1
        logging.info("Fetched clips successfully!")
        for k, v in warning_counts.items():
            logging.warning("%s occurred %d times", k, v)
        return warning_counts

    def auto_mask(self) -> None:
        """Mask every raw clip into ``PATHS.MASKED_CLIPS`` with the U-Net
        at ``PATHS.AUTOMASK_MODEL_PATH`` (reference
        ``dataset_creator.py:86-95``), on the creator's device."""
        automask = self.cfg["DATA"]["AUTOMASK"]
        UnetSegmentation(device=self.device).predict(
            input_paths=self.cfg["PATHS"]["RAW_CLIPS"],
            output_path=self.cfg["PATHS"]["MASKED_CLIPS"],
            model_path=self.cfg["PATHS"]["AUTOMASK_MODEL_PATH"],
            output_format=automask["OUTPUT_FORMAT"],
            edge_preserve=automask["EDGE_PRESERVE"],
            save_cropped_roi=automask["SAVE_CROPPED_ROI"],
        )
