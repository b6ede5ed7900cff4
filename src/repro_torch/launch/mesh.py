"""The local device mesh: the port of ``repro/launch/mesh.py``'s
``make_local_mesh``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axes ``("data", "model")`` over an initialised default
process group of exactly ``data · model`` ranks, which the caller starts
(``torch.distributed.init_process_group`` with an address, a world size
and a rank: nothing here discovers a cluster).  On CUDA (the default) a
mesh of more than one rank raises: the port targets one card, so a
world size above 1 runs only on the CPU (``device="cpu"``, gloo), and
nothing falls back from the card to the CPU.  The reference's TPU
production meshes and v5e constants are not carried over (ROADMAP A11.5).
"""
from __future__ import annotations

import torch.distributed as dist

from ..algorithms.common import resolve_device


def make_local_mesh(model: int = 1, data: int = 1, *, device=None):
    """A ``(data, model)`` DeviceMesh over the default process group, on
    ``device``'s type (``None``: CUDA, raising without a card)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    size = data * model
    if dev.type == "cuda" and size > 1:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {size} CUDA ranks; the port runs "
                           f"one card, and world sizes above 1 run on the CPU (device='cpu')")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group "
                           f"with world_size={size} first")
    if dist.get_world_size() != size:
        raise ValueError(f"a ({data}, {model}) mesh needs a world of {size} ranks, "
                         f"not {dist.get_world_size()}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
