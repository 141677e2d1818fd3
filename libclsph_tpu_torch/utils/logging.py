"""Logging for the framework.

The reference logs parameter tables and per-frame progress with raw
``std::cout`` (SURVEY.md §5 "Metrics / logging"); here it is standard
``logging`` with a compact default format, configurable per deployment.
"""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def _configure_root():
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("LIBCLSPH_TORCH_LOG", "INFO").upper()
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger("libclsph_tpu_torch")
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("libclsph_tpu_torch"):
        name = "libclsph_tpu_torch." + name
    return logging.getLogger(name)
