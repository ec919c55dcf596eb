"""Library logger for `repro_torch.*` — level-gated, quiet by default.

The port's copy of the JAX package's ``obs/log.py``.  Library code logs
through `repro_torch.obs.log` instead of `print()`, so test and bench
output stay clean unless someone opts in.  Launchers (the `__main__`
paths of `launch/train.py` and `launch/serve.py`) call `configure()` so
CLI users see progress lines; user-facing *results* stay on plain stdout
prints in the launchers.

    from repro_torch.obs import log
    log.info("[train] step %d", step)

Opt in from the environment with REPRO_LOG=debug|info|warning (the same
variable as the JAX package's logger).
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Union

_LOGGER = logging.getLogger("repro_torch")
_LOGGER.addHandler(logging.NullHandler())
_LOGGER.setLevel(os.environ.get("REPRO_LOG", "WARNING").upper()
                 if os.environ.get("REPRO_LOG") else logging.WARNING)

_configured = False


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"repro_torch.{name}" if name
                             else "repro_torch")


def configure(level: Optional[Union[int, str]] = None, *,
              stream=None) -> logging.Logger:
    """Attach a stream handler (idempotent) and set the level.
    `level=None` reads REPRO_LOG, defaulting to "info" (this is the
    launcher entry point — libraries never call configure)."""
    global _configured
    if level is None:
        level = os.environ.get("REPRO_LOG", "info")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    if not _configured:
        h = logging.StreamHandler(stream or sys.stdout)
        h.setFormatter(logging.Formatter("%(message)s"))
        _LOGGER.addHandler(h)
        _configured = True
    _LOGGER.setLevel(level)
    return _LOGGER


# module-level convenience: from repro_torch.obs import log; log.info(...)
debug = _LOGGER.debug
info = _LOGGER.info
warning = _LOGGER.warning
error = _LOGGER.error
