"""Structured logging (replacement for the reference's bare prints)."""

from __future__ import annotations

import logging
import sys

_CONFIGURED = False


def get_logger(name: str = "gcn_maxcut") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        root = logging.getLogger("gcn_maxcut")
        if not root.handlers:
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(name)
