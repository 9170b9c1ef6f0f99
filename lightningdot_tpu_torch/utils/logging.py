"""The drivers' logger (the port's copy of ``LOGGER`` and its format,
lightningdot_tpu/utils/logging.py:15-19; reference
uniter_model/utils/logger.py). The running meters and the metrics sink of
that module come with the training driver (ROADMAP A7)."""
from __future__ import annotations

import logging

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("__main__")
