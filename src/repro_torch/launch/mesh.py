"""The production mesh and the hardware the roofline prices it on.

Functions, not module-level meshes: importing this module touches no
process group and no card.  :func:`make_production_mesh` lays the
reference's 256 (or 512) devices out as H100s: the model axis inside one
8-GPU NVLink node, the data (and pod) axes across nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..distributed.sharding import DATA, MODEL, POD


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device of a mesh and its links, as the analytic terms and the
    roofline price them."""

    name: str
    peak_bf16: float      # dense bf16 FLOP/s
    hbm_bw: float         # device memory bytes/s
    hbm_bytes: int        # device memory bytes
    nvlink_bw: float      # bytes/s each way, the model axis (inside a node)
    network_bw: float     # bytes/s each way, the data and pod axes

    def link_bw(self, axis: str) -> float:
        """The rate of the link that ``axis``'s collectives cross."""
        return self.nvlink_bw if axis == MODEL else self.network_bw


#: NVIDIA H100 SXM5 80 GB: the data sheet's dense bf16 tensor-core rate and
#: HBM3 rate; device memory as ``torch.cuda.get_device_properties(0)
#: .total_memory`` reports it for "NVIDIA H100 80GB HBM3"; NVLink 4 at
#: 900 GB/s per card, 450 GB/s each way.  The network link is a deployment
#: assumption: one 400 Gb/s ConnectX-7 per GPU, as in NVIDIA's DGX H100
#: (eight per node), 50 GB/s each way.
H100_SXM = Hardware(name="NVIDIA H100 SXM 80GB", peak_bf16=989e12,
                    hbm_bw=3.35e12, hbm_bytes=85_017_493_504,
                    nvlink_bw=450e9, network_bw=50e9)

#: GPUs of one NVLink node: the model axis stays inside one
NODE_GPUS = 8


def production_shape(multi_pod: bool = False) -> dict:
    """``{axis: size}`` of the production mesh: (data, model) = (32, 8), or
    (pod, data, model) = (2, 32, 8)."""
    if multi_pod:
        return {POD: 2, DATA: 32, MODEL: NODE_GPUS}
    return {DATA: 32, MODEL: NODE_GPUS}


def make_production_mesh(multi_pod: bool = False) -> Any:
    """The production ``DeviceMesh`` over the default process group, which
    must hold 256 ranks (512 with ``multi_pod``): the dry-run brings up a
    ``fake`` group of that size on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_shape(multi_pod)
    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_host_mesh(model_parallel: int = 1) -> Any:
    """A (data, model) ``DeviceMesh`` over the ranks of the group that is
    up, ``model_parallel`` of them on the model axis, on the device its
    backend drives (``cuda`` under NCCL, else ``cpu``)."""
    import torch.distributed as dist

    from ..distributed.sharding import make_mesh

    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{model_parallel} model ranks do not divide the "
                         f"{n} ranks of the group")
    device = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return make_mesh((n // model_parallel, model_parallel), device)
