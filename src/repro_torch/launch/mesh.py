"""The local device mesh and the card's constants: the port of
``repro/launch/mesh.py``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axes ``("data", "model")`` over an initialised default
process group of exactly ``data · model`` ranks, which the caller starts
(``torch.distributed.init_process_group`` with an address, a world size
and a rank: nothing here discovers a cluster).  On CUDA (the default) a
mesh of more than one rank raises: the port targets one card, so a
world size above 1 runs on the CPU (``device="cpu"``, gloo), and
nothing falls back from the card to the CPU.  A caller that shares one
card between ranks on purpose builds its ``DeviceMesh`` itself
(``chip_smoke.py``'s phase ``tp_ep``).

Where the reference keeps its v5e constants, the port keeps the H100's:
the published peaks of the NVIDIA H100 SXM (80 GB HBM3, 700 W), which
``distributed/analysis.py``'s roofline and ``chip_smoke.py``'s kernel
bounds both divide by.  The reference's ``make_production_mesh`` (256
and 512 TPU v5e chips, with a ``pod`` axis) has no counterpart: one
H100 has no pod, and ``distributed/sharding.py::to_placements`` cannot
place one tensor dim over two mesh axes, which the pod mesh needs.
"""
from __future__ import annotations

import torch.distributed as dist

from ..algorithms.common import resolve_device

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12       # bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3
HBM_BYTES = 80e9               # the card's memory
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, one direction, per card of a multi-card node


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
