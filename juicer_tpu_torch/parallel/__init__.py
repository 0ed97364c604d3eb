"""Batch decoding over several devices and processes."""

from .mesh import BatchDecoder, make_mesh

__all__ = ["make_mesh", "BatchDecoder"]
