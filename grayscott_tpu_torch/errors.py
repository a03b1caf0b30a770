"""The error of a configuration the port does not run: the port's copy of
``grayscott_tpu/errors.py``.

A rejected combination of knobs raises :class:`UnsupportedConfigError`, a
``ValueError`` whose ``.combo`` names the knobs at fault; a malformed
single argument raises a plain ``ValueError``.
"""

from __future__ import annotations


class UnsupportedConfigError(ValueError):
    """A configuration combination the port does not support."""

    def __init__(self, message: str, combo: str | None = None):
        super().__init__(message)
        self.combo = combo
