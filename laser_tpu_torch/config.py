"""Global configuration for laser_tpu_torch (port of laser_tpu/config.py).

There is no ``interpret`` knob: a wrapper runs its CUDA kernel for a CUDA
tensor and its plain PyTorch version for a CPU tensor, so the device of the
data makes the choice.

``matmul_precision`` keeps laser_tpu's names, mapped to Hopper:

  "highest"  full fp32 FFMA in the f32 kernel paths, and TF32 off in the
             plain versions (laser_tpu: 6-pass bf16 on the MXU). The default.
  "high"     3xTF32 (laser_tpu: 3-pass bf16). Not ported: raises.
  "default"  TF32 (laser_tpu: 1-pass bf16). Not ported: raises.

``vector_math_algorithm`` is the default tier of ``ops.vector_math``'s
exp/log/tanh/sigmoid: "accurate" (laser_tpu's polynomial cores, within
1e-6 of float64) or "fast" (CUDA's own functions; see csrc/vector_math.cuh).

``gemm_bm``, ``gemm_bn`` and ``gemm_bk`` override the block sizes that
``ops.gemm.tiling.plan_tiles`` chooses for the packed GEMM (None: planned),
as laser_tpu's fields override its planner.

``elementwise_grain`` and ``reduction_grain`` are laser_tpu's names for
the VMEM block sizes of a v5e. The port accepts them, so a laser_tpu
configuration carries over, and does not read them: the elementwise and
reduction templates size their thread blocks from constants chosen for the
H100 (csrc/foreach.cuh kElementwiseGrain, kReduceGrain).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

# the highest rank of a TensorView (laser_tpu/config.py LASER_MAXRANK, after
# the reference's laser/dynamic_stack_arrays.nim:6), and of the strided
# template's iteration space (csrc/foreach.cuh kMaxDims)
LASER_MAXRANK = 6

PRECISIONS = ("default", "high", "highest")
ALGORITHMS = ("accurate", "fast")


@dataclasses.dataclass
class LaserConfig:
    matmul_precision: str = "highest"
    vector_math_algorithm: str = "accurate"
    elementwise_grain: int = 16384  # accepted, unused (see above)
    reduction_grain: int = 65536    # accepted, unused
    gemm_bm: Optional[int] = None
    gemm_bn: Optional[int] = None
    gemm_bk: Optional[int] = None


_config = LaserConfig()


def get_config() -> LaserConfig:
    return _config


def set_config(**kwargs) -> LaserConfig:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown laser config field: {k}")
        if k == "matmul_precision" and v not in PRECISIONS:
            raise ValueError(f"matmul_precision must be one of {PRECISIONS}, got {v!r}")
        if k == "vector_math_algorithm" and v not in ALGORITHMS:
            raise ValueError(f"vector_math_algorithm must be one of {ALGORITHMS}, got {v!r}")
        if k in ("elementwise_grain", "reduction_grain") and not (isinstance(v, int) and v > 0):
            raise ValueError(f"{k} must be a positive int, got {v!r}")
        if k in ("gemm_bm", "gemm_bn", "gemm_bk") and not (
                v is None or isinstance(v, int) and v > 0):
            raise ValueError(f"{k} must be None or a positive int, got {v!r}")
        setattr(_config, k, v)
    return _config


@contextlib.contextmanager
def config_override(**kwargs):
    old = {k: getattr(_config, k) for k in kwargs}
    try:
        set_config(**kwargs)
        yield _config
    finally:
        set_config(**old)


def check_f32_precision() -> None:
    """Raise unless the f32 matmul precision is one the port implements."""
    p = _config.matmul_precision
    if p != "highest":
        raise NotImplementedError(
            f"matmul_precision={p!r} (TF32 / 3xTF32 on Hopper) is not ported; "
            "only 'highest' (full fp32) is")


def pin_fp32_matmul() -> None:
    """Keep PyTorch's own f32 products in full fp32 (TF32 off), the plain
    versions' counterpart of precision 'highest'."""
    check_f32_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
