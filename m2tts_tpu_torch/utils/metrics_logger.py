"""Training metrics sinks: CSV, JSONL, and wandb when it imports.

A copy of ``m2tts_tpu/utils/metrics_logger.py`` for the PyTorch port.
"""

from __future__ import annotations

import csv
import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Union

logger = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, log_dir: Union[str, Path], backend: str = "csv",
                 wandb_project: Optional[str] = None, run_name: Optional[str] = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.backend = backend
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields = None
        self._jsonl_file = None
        self._wandb = None
        if backend == "wandb":
            try:
                import wandb

                wandb.init(project=wandb_project or "m2tts",
                           name=run_name)
                self._wandb = wandb
            except Exception as e:  # wandb not installed / offline
                logger.warning("wandb unavailable (%s); falling back to csv", e)
                self.backend = "csv"

    def log(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        if self.backend == "csv":
            self._log_csv(row)
        elif self.backend == "jsonl":
            self._log_jsonl(row)
        elif self.backend == "wandb" and self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def _log_csv(self, row: Dict) -> None:
        """One well-formed CSV even though train and validation rows carry
        different key sets (both trainers alternate them in one logger).
        The header is the growing UNION of all seen fields; when a row
        introduces new fields the file is rewritten once with the extended
        header (missing cells are blank). Appending rows with a different
        layout under the original header — the old behavior — misaligns
        every later column for any CSV consumer."""
        new_fields = sorted(row.keys())
        if self._csv_writer is not None and all(
                f in self._csv_fields for f in new_fields):
            self._csv_writer.writerow(row)
            self._csv_file.flush()
            return
        path = self.log_dir / "metrics.csv"
        if self._csv_file:
            self._csv_file.close()
        existing_fields: list = []
        existing_rows: list = []
        if path.exists():
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                existing_fields = list(reader.fieldnames or [])
                if any(f not in existing_fields for f in new_fields):
                    existing_rows = list(reader)  # needed for the rewrite
        fields = list(dict.fromkeys([*existing_fields, *new_fields]))
        if existing_fields and fields != existing_fields:
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields, restval="",
                                   extrasaction="ignore")
                w.writeheader()
                for old in existing_rows:
                    old.pop(None, None)  # ragged legacy rows: drop extras
                    w.writerow(old)
            write_header = False
        else:
            write_header = not existing_fields
        self._csv_file = open(path, "a", newline="")
        self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=fields,
                                          restval="", extrasaction="ignore")
        self._csv_fields = fields
        if write_header:
            self._csv_writer.writeheader()
        self._csv_writer.writerow(row)
        self._csv_file.flush()

    def _log_jsonl(self, row: Dict) -> None:
        if self._jsonl_file is None:
            self._jsonl_file = open(self.log_dir / "metrics.jsonl", "a")
        self._jsonl_file.write(json.dumps(row) + "\n")
        self._jsonl_file.flush()

    def close(self) -> None:
        # Reset handles to None so a logger closed by one train() call is
        # lazily reopened (append mode) if training is driven again — the
        # files open on first write, so close/reuse is safe.
        if self._csv_file:
            self._csv_file.close()
            self._csv_file = None
            self._csv_writer = None
            self._csv_fields = None
        if self._jsonl_file:
            self._jsonl_file.close()
            self._jsonl_file = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
