"""Named-logger setup mirroring the reference's rosconsole logger tree.

Port of ``rgbdslam_v2_tpu/utils/logsetup.py``: the same code, names and output.

Capability parity: the reference configures named loggers rgbdslam /
timings / statistics / eval via log.conf (reference: log.conf,
rgbd_benchmark/log_eval.conf) — the eval harness scrapes WARN-level "eval"
lines for runtimes. Here: standard python logging under the "rgbdslam"
root with the same child names.
"""
from __future__ import annotations

import logging
import sys

NAMES = ("rgbdslam", "rgbdslam.timings", "rgbdslam.statistics", "rgbdslam.eval")


def configure_logging(level=logging.INFO, timings_level=logging.WARNING,
                      stream=None):
    root = logging.getLogger("rgbdslam")
    root.setLevel(level)
    if not root.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s")
        )
        root.addHandler(h)
    logging.getLogger("rgbdslam.timings").setLevel(timings_level)
    return root


def get_logger(name: str = "rgbdslam") -> logging.Logger:
    if not name.startswith("rgbdslam"):
        name = f"rgbdslam.{name}"
    return logging.getLogger(name)
