"""NVIDIA Hopper capability table (port of laser_tpu/device_info.py).

Keyed on ``torch.cuda.get_device_name()``, because the SXM, NVL and PCIe
H100 parts differ in SM count, clocks and memory. Figures are NVIDIA's data
sheet values (dense rates, no sparsity, at the part's full power limit);
they feed roofline accounting, never correctness. A card set below its
power limit runs slower: report ``nvidia-smi``'s power.limit beside any
share of these peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

GB = 1000**3
KiB = 1024


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    name: str
    sms: int
    smem_per_block: int      # opt-in dynamic shared memory per block, bytes
    hbm_bytes: int
    hbm_gbps: float          # device memory bandwidth, GB/s
    bf16_tflops: float       # dense tensor-core bf16/fp16, fp32 accumulate
    tf32_tflops: float       # dense tensor-core TF32
    f32_tflops: float        # FFMA outside the tensor cores
    int8_tops: float         # dense tensor-core int8, int32 accumulate
    f64_tflops: float        # dense FP64 tensor cores (DMMA)


H100_TABLE = {
    "h100-sxm": GpuSpec("H100 SXM5 80GB", 132, 227 * KiB, 80 * GB, 3350.0, 989.0, 495.0, 67.0,
                        1979.0, 67.0),
    "h100-nvl": GpuSpec("H100 NVL 94GB", 132, 227 * KiB, 94 * GB, 3900.0, 835.0, 418.0, 60.0,
                        1670.0, 60.0),
    "h100-pcie": GpuSpec("H100 PCIe 80GB", 114, 227 * KiB, 80 * GB, 2000.0, 756.0, 378.0, 51.0,
                         1513.0, 51.0),
}


def classify_device_name(name: str) -> Optional[str]:
    """Table key for a CUDA device name, or None for a card not in it."""
    n = name.lower()
    if "h100" not in n:
        return None
    if "pcie" in n:
        return "h100-pcie"
    if "nvl" in n:
        return "h100-nvl"
    return "h100-sxm"  # "NVIDIA H100 80GB HBM3" is the SXM part


def detect(device_name: Optional[str] = None) -> GpuSpec:
    """Spec of the named card, or of CUDA device 0. Raises for a card that
    is not in the table: a roofline against a guessed peak is no roofline."""
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device visible")
        device_name = torch.cuda.get_device_name(0)
    key = classify_device_name(device_name)
    if key is None:
        raise KeyError(f"no capability record for {device_name!r}")
    return H100_TABLE[key]
