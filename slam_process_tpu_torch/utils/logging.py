"""Console (and optional file) logging, and the health counters stages
report.

A copy of ``slam_process_tpu/utils/logging.py``: one logger factory and a
small counter container that each stage fills (valid and discarded frame
counts, rows after correction, groups and baselines), which the CLI prints.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from pathlib import Path
from typing import Dict, Optional


def get_logger(name: str = "slam_process_tpu_torch", log_file: Optional[Path] = None,
               console_level: int = logging.INFO,
               file_level: int = logging.DEBUG) -> logging.Logger:
    """Create (or fetch) a logger writing to stdout and optionally a file.

    Unlike the JAX package's, it keeps propagating, so handlers an
    application (or pytest's log capture) sets on the root see its records
    and those of its children, such as each ``Session``'s logger."""
    logger = logging.getLogger(name)
    logger.setLevel(min(console_level, file_level))
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(console_level)
        sh.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        logger.addHandler(sh)
    if log_file is not None:
        log_file = Path(log_file)
        if not any(isinstance(h, logging.FileHandler)
                   and Path(getattr(h, "baseFilename", "")) == log_file
                   for h in logger.handlers):
            log_file.parent.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_file, mode="w", encoding="utf-8")
            fh.setLevel(file_level)
            fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(fh)
    return logger


@dataclasses.dataclass
class StageCounters:
    """Health counters one stage reports."""

    name: str
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, key: str, value: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + int(value)

    def set(self, key: str, value: int) -> None:
        self.counts[key] = int(value)

    def log(self, logger: logging.Logger) -> None:
        logger.info("[%s] %s", self.name, " ".join(f"{k}={v}" for k, v in self.counts.items()))
