"""Run logging: the console and a rotating `info.log` in the run directory
(port of `mvsformer_tpu/utils/logging.py`)."""

from __future__ import annotations

import logging
import logging.handlers
import os


def setup_logging(run_dir: str, level=logging.INFO) -> logging.Logger:
    os.makedirs(run_dir, exist_ok=True)
    logger = logging.getLogger("mvsformer_torch")
    logger.setLevel(level)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(console)
    rotating = logging.handlers.RotatingFileHandler(
        os.path.join(run_dir, "info.log"), maxBytes=10 * 1024 * 1024, backupCount=5)
    rotating.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(rotating)
    return logger
