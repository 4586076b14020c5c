"""The port's one-card mesh and the card's roofline constants
(``repro.launch.mesh``).

The reference lays SDFL-B out on TPU v5e pods (16×16 or 2×16×16 chips,
axes ``data`` and ``model``, plus ``pod`` across pods). The port runs on
one NVIDIA H100: both axes have size 1, every tensor lies whole on the
card, and nothing moves between chips, so there is no interconnect rate.
The multi-pod mesh has no counterpart.

The constants are NVIDIA's published peaks of the H100 SXM at its 700 W
power limit (the dense rates, without sparsity). f32 products run with
TF32 off (``repro_torch.device.resolve_device``), so they are held to the
ordinary f32 rate, not to the tensor cores'.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple


class Mesh(NamedTuple):
    """One card: the reference's axis names, each of size 1."""
    axis_names: Tuple[str, ...]
    shape: dict
    devices: int


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        raise ValueError("one card; the multi-pod mesh has no counterpart")
    return Mesh(("data", "model"), {"data": 1, "model": 1}, 1)


def data_axes(mesh: Mesh) -> tuple:
    """The axes the worker/batch dim lies along."""
    return ("data",)


def tp_size(mesh: Mesh) -> int:
    return mesh.shape["model"]


def dp_size(mesh: Mesh) -> int:
    return mesh.shape["data"]


# H100 SXM (700 W) constants for the roofline terms
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 on the ordinary cores
HBM_BW = 3.35e12                # bytes/s
HBM_BYTES = 85_017_493_504      # the H100 80GB HBM3's total_memory (CUDA)
