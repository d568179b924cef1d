"""Ping-pong scratch buffers for the multi-level drivers.

A level reads its active array while it writes the next one, so the
drivers (ops/pyramid2d.py, ops/dwt1d.py, ops/wpt.py) alternate between
two buffers and no launch writes the memory it reads.  ``ALLOCATED``
counts the bytes the buffers took, over every driver call.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Scratch", "ALLOCATED"]

ALLOCATED = {"bytes": 0}


class Scratch:
    """Two ping-pong buffers, like ``like``: ``caps`` samples each (for a
    pyramid, the first level's band, then the second's), allocated at
    first use."""

    def __init__(self, like, caps):
        self.like = like
        self.caps = caps
        self.bufs = [None, None]
        self.order = []     # the buffers in the order they were allocated

    def buffer(self, i):
        """Buffer ``i``, allocated at its first use."""
        buf = self.bufs[i]
        if buf is None:
            buf = self.bufs[i] = torch.empty(
                self.caps[i], dtype=self.like.dtype, device=self.like.device)
            ALLOCATED["bytes"] += buf.nbytes
            self.order.append(i)
        return buf

    def view(self, i, *shape):
        """The first ``prod(shape)`` samples of buffer ``i``, as ``shape``."""
        return self.buffer(i)[: math.prod(shape)].view(shape)
