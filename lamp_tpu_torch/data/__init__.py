"""Data utilities. Counterpart of :mod:`lamp_tpu.data` (so far
:func:`pack_documents`)."""

from .lm_data import pack_documents

__all__ = ["pack_documents"]
