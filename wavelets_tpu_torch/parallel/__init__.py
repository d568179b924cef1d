"""Multi-device execution: meshes of torch devices, sharded transforms
with ring halo exchange, and the distributed application layer
(best-basis, noisest, denoise, packets, MODWT).

A mesh names its devices: ``Mesh(["cuda:0"] * 4, ("x",))`` is four shards
on one card, ``Mesh(["cpu"] * 4, ("x",))`` four on the CPU, and
``make_mesh()`` takes the visible CUDA devices.  The drivers return
:class:`Sharded` arrays; ``.gather(device)`` assembles one.
"""

from .mesh import Mesh, Sharded
from .sharded import (make_mesh, shard_rows, dwt1, idwt1, dwt2, idwt2,
                      dwt3, idwt3)
from .apps import (bestbasistree, noisest, denoise, wpt, iwpt,
                   modwt, imodwt)
from . import mesh2d

__all__ = ["make_mesh", "shard_rows", "dwt1", "idwt1", "dwt2", "idwt2",
           "dwt3", "idwt3", "bestbasistree", "noisest", "denoise",
           "wpt", "iwpt", "modwt", "imodwt", "mesh2d", "Mesh", "Sharded"]
