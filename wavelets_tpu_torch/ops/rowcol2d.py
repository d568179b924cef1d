"""One periodic 2-D level as two launches, all the rows and then all the
columns: the split route's level.

The counterpart of the row and column kernels of
``wavelets_tpu/ops/pallas/lifting2d.py`` (``_row_fw_kernel`` /
``_row_inv_kernel``, ``_col_fw_kernel``, ``_col_inv_kernel``) and of
``filter2d.py`` (``_rows``' kernels, ``_col_fw_kernel``,
``_col_inv_kernel``), which the JAX package runs under
``WAVELETS_TPU_MXU2D=0``.  It needs no kernel of its own:

* forward: kernel E (``level1d.level1d_fw``) runs over the level's rows
  into a contiguous scratch laid out as ``[s | d]`` per row; then kernel I
  (``axis0.axis0_fw``) runs down that scratch's columns.  I's scaling half
  is exactly the packed rows ``[LL | LH]`` and its detail half ``[HL |
  HH]``, so I writes straight into the level's place in the packed array.
* inverse: kernel J (``axis0.axis0_inv``, reading the deeper level's LL
  through its ``corner`` view) runs down the packed level's columns into a
  scratch, then kernel F (``level1d.level1d_inv``) over its rows.

E and F take ``(rows, n)`` with one row stride.  The scratch and a
contiguous batch have one; a batch of strided image views (a deeper
level's LL inside the packed array, B > 1) does not, and E (or F) then
runs once per image rather than copying the batch.  On the CPU each launch takes its kernel's plain version
(``rowcol_fw_plain``, ``rowcol_inv_plain`` compose the four plain
versions).
"""

from __future__ import annotations

import torch

from . import axis0, level1d

__all__ = ["rowcol_fw", "rowcol_fw_plain", "rowcol_inv", "rowcol_inv_plain"]

_KERNELS = (level1d.level1d_fw, axis0.axis0_fw, axis0.axis0_inv,
            level1d.level1d_inv)
_PLAIN = (level1d.level1d_fw_plain, axis0.axis0_fw_plain,
          axis0.axis0_inv_plain, level1d.level1d_inv_plain)


def _row_views(v):
    """``v (B, m, n)`` as a list of ``(rows, n)`` views with one row stride
    each: one view where the batch stride is m row strides, else one per
    image."""
    B, m, n = v.shape
    if B == 1 or v.stride(0) == m * v.stride(1):
        return [v.as_strided((B * m, n), (v.stride(1), v.stride(2)))]
    return list(v.unbind(0))


def _paired_rows(v, s):
    """The row views of ``v`` and of the contiguous scratch ``s``, cut the
    same way (one view each, or one per image)."""
    rows = _row_views(v)
    return rows, (_row_views(s) if len(rows) == 1 else list(s.unbind(0)))


def _scratch(v, scratch):
    if scratch is None:
        return torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if (tuple(scratch.shape) != tuple(v.shape) or scratch.dtype != v.dtype
            or scratch.device != v.device or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be a contiguous {tuple(v.shape)} "
                         f"{v.dtype} tensor on {v.device}")
    return scratch


def _fw(x, wt, out, scratch, kernels):
    e_fw, i_fw, _, _ = kernels
    B, m, n = x.shape
    if m % 2 or n % 2:
        raise ValueError(f"rowcol_fw needs even sizes, got {(m, n)}")
    s = _scratch(x, scratch)
    nh = n // 2
    for rows, srows in zip(*_paired_rows(x, s)):
        e_fw(rows, wt, srows[:, :nh], srows[:, nh:])
    i_fw(s, wt, out[:, : m // 2], out[:, m // 2:])
    return out


def _inv(y, wt, out, corner, scratch, kernels):
    _, _, j_inv, f_inv = kernels
    B, m, n = y.shape
    if m % 2 or n % 2:
        raise ValueError(f"rowcol_inv needs even sizes, got {(m, n)}")
    s = _scratch(y, scratch)
    j_inv(y[:, : m // 2], y[:, m // 2:], wt, out=s, corner=corner)
    nh = n // 2
    for orows, srows in zip(*_paired_rows(out, s)):
        f_inv(srows[:, :nh], srows[:, nh:], wt, out=orows)
    return out


def rowcol_fw(x, wt, out, scratch=None):
    """Forward level of ``x (B, m, n)`` (unit column stride) into the packed
    level ``out (B, m, n)``: ``[LL | LH]`` in its top half, ``[HL | HH]``
    in its bottom half.  ``scratch`` is a contiguous ``(B, m, n)`` buffer
    (allocated when None); ``out`` may be ``x`` itself, since E has read
    all of ``x`` before I writes.  Returns ``out``."""
    return _fw(x, wt, out, scratch, _KERNELS)


def rowcol_fw_plain(x, wt, out, scratch=None):
    """:func:`rowcol_fw` through the plain versions of E and I."""
    return _fw(x, wt, out, scratch, _PLAIN)


def rowcol_inv(y, wt, out, corner=None, scratch=None):
    """Inverse level: the packed level ``y (B, m, n)`` -> ``out (B, m,
    n)``, whose rows must have one stride per image.  ``corner (B, m/2,
    n/2)``, where given, stands for y's LL quadrant.  ``scratch`` as for
    :func:`rowcol_fw`; it may not overlap ``y``, ``corner`` or ``out``.
    Returns ``out``."""
    return _inv(y, wt, out, corner, scratch, _KERNELS)


def rowcol_inv_plain(y, wt, out, corner=None, scratch=None):
    """:func:`rowcol_inv` through the plain versions of J and F."""
    return _inv(y, wt, out, corner, scratch, _PLAIN)
