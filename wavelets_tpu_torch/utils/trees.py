"""Wavelet-packet trees.

A WPT tree over a length-n signal (L = maxtransformlevels(n)) is a boolean
NumPy vector of length 2^L - 1, heap-indexed: 0-based node i has children
2i+1 and 2i+2; depth-d nodes occupy indices [2^d - 1, 2^(d+1) - 1).  A node
set to True means "transform this segment one more level".

Matches the reference semantics (BitVector, 1-based heap) at
src/Util/util_main.jl:298-344.  Trees are host-side static
data: they select which Pallas/XLA segment transforms run, and are never
traced.
"""

from __future__ import annotations

import numpy as np

from .indexing import maxtransformlevels

__all__ = ["maketree", "isvalidtree", "treedepth"]


def treedepth(tree: np.ndarray) -> int:
    """Number of depth layers L in a tree of length 2^L - 1."""
    nb = len(tree)
    L = (nb + 1).bit_length() - 1
    if 2 ** L - 1 != nb:
        raise ValueError(f"tree length {nb} is not 2^L - 1")
    return L


def isvalidtree(x, tree: np.ndarray) -> bool:
    """True if the tree matches x's depth and no False node has a True child.

    reference: src/Util/util_main.jl:301-313
    """
    ns = maxtransformlevels(x)
    nb = len(tree)
    if nb != 2 ** ns - 1:
        return False
    if ns == 0:          # no factor of 2: the only valid tree is empty
        return True
    tree = np.asarray(tree, dtype=bool)
    # internal nodes occupy [0, 2^(ns-1) - 1); children of node i are
    # 2i+1 / 2i+2, so tree[1:] pairs up as the child couples in order —
    # vectorized (a 2^20-signal tree has ~0.5M internal nodes)
    n_int = 2 ** (ns - 1) - 1
    if n_int == 0:
        return True
    child_any = tree[1: 2 * n_int + 1].reshape(-1, 2).any(axis=1)
    return bool(np.all(tree[:n_int] | ~child_any))


def maketree(n: int, L: int | None = None, s: str = "full") -> np.ndarray:
    """Construct a tree for a length-n signal.

    s="full": all nodes in the first L depth layers are active.
    s="dwt":  only the left-spine nodes of the first L layers are active
              (equivalent to a plain L-level DWT).

    reference: src/Util/util_main.jl:321-344
    """
    ns = maxtransformlevels(n)
    if L is None:
        L = ns
    if not (0 <= L <= ns):
        raise ValueError(f"L={L} out of range for n={n} (max {ns})")
    tree = np.zeros(2 ** ns - 1, dtype=bool)
    if s == "full":
        tree[: 2 ** L - 1] = True
    elif s == "dwt":
        for i in range(L):
            tree[2 ** i - 1] = True
    else:
        raise ValueError(f"unknown tree kind {s!r}")
    return tree
