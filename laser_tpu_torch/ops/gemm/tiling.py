"""Block planning for the packed GEMM (port of laser_tpu/ops/gemm/tiling.py).

laser_tpu sizes (bm, bn, bk) so that double-buffered input blocks and the
accumulator fit a TPU core's VMEM, from a table of a v5e's measured tiles.
Neither carries over. Here a plan is sized for the packed kernels of
csrc/packed_gemm.cu: bm and bn are multiples of the CTA tile (128 x 128),
bk a multiple of the k step (64 for bf16 and f16, 128 for int8: the wgmma
routes' box depths, so that every planned 16-bit and int8 plan takes its
wgmma route; 16 for f32, the simt route's), and two stages of a CTA's (CM
x bk) A slab and (bk x CN) B slab must fit half the shared memory a block may use
(``device_info``), so that two CTAs of the classic kernels' "blocks" route,
which stages each k-block whole (int8: 64 deep at a time), share an SM.
Among the depths that fit, the plan takes the one that pads K least, the
deepest on a tie. ``overrides`` and the config's ``gemm_bm`` / ``gemm_bn``
/ ``gemm_bk`` fields replace a planned size, rounded up to the CTA tile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...config import get_config
from ...device_info import H100_TABLE, detect
from ...utils import cdiv, round_step_up


@dataclasses.dataclass(frozen=True)
class GemmTiles:
    """A block plan. ``vmem_limit_bytes`` is laser_tpu's field, kept so a
    laser_tpu plan builds here unchanged; the port accepts and never reads
    it (``plan_tiles`` records the shared memory it planned for)."""
    bm: int
    bn: int
    bk: int
    vmem_limit_bytes: int

    def grid(self, M: int, N: int, K: int) -> Tuple[int, int, int]:
        return (cdiv(M, self.bm), cdiv(N, self.bn), cdiv(K, self.bk))


# the packed kernels' (CTA rows, CTA columns, k step) by input type
# (csrc/packed_gemm.cu CM, CN; the k step f32's gather slab depth, the
# 16-bit wgmma route's box depth; int8: the int8 wgmma route's 128 x 128
# tile and 128-deep step), and the stages of the classic kernels' ring
CTA = {torch.float32: (128, 128, 16), torch.bfloat16: (128, 128, 64),
       torch.float16: (128, 128, 64), torch.int8: (128, 128, 128)}
STAGES = 2


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a NumPy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    name = np.dtype(dtype).name
    return getattr(torch, name)


def stage_bytes(dtype: torch.dtype, bk: int) -> int:
    """Shared memory of the blocks route's ring at depth ``bk``: STAGES
    stages of a CTA's padded A and B slabs."""
    cm, cn, _ = CTA.get(dtype, CTA[torch.float32])
    size = torch.empty((), dtype=dtype).element_size()
    pad = 16 // size
    return STAGES * (cm * (bk + pad) + bk * (cn + pad)) * size


def smem_per_block() -> int:
    """The shared memory a block may opt into on this card, or on the H100
    SXM the port is planned for when no card is visible."""
    if torch.cuda.is_available():
        return detect().smem_per_block
    return H100_TABLE["h100-sxm"].smem_per_block


def plan_tiles(M: int, N: int, K: int, in_dtype, acc_dtype=torch.float32,
               *, n_inputs: int = 2, has_c_input: bool = False,
               overrides: Optional[Tuple[Optional[int], Optional[int], Optional[int]]] = None
               ) -> GemmTiles:
    """Choose (bm, bn, bk) for an (M, K) x (K, N) packed product (see the
    module docstring). ``acc_dtype``, ``n_inputs`` and ``has_c_input`` are
    laser_tpu's arguments and change nothing here: the kernel stages
    exactly A and B, the accumulators live in registers and C is read
    straight from device memory by the epilogue."""
    del acc_dtype, n_inputs, has_c_input
    dt = as_torch_dtype(in_dtype)
    cm, cn, ck = CTA.get(dt, CTA[torch.float32])
    cfg = get_config()
    o_bm, o_bn, o_bk = overrides if overrides else (cfg.gemm_bm, cfg.gemm_bn, cfg.gemm_bk)
    bm = round_step_up(o_bm, cm) if o_bm else cm
    bn = round_step_up(o_bn, cn) if o_bn else cn
    smem = smem_per_block()
    if o_bk:
        bk = round_step_up(o_bk, ck)
    else:
        kr = round_step_up(max(K, 1), ck)
        fits = [d for d in range(ck, kr + 1, ck) if stage_bytes(dt, d) <= smem // 2]
        fits = fits or [ck]
        bk = min(fits, key=lambda d: (cdiv(K, d) * d, -d))
    return GemmTiles(bm=bm, bn=bn, bk=bk, vmem_limit_bytes=smem)
