from .api import gemm, gemm_reference, gemm_strided
from .autodiff import gemm_ad, linear, linear_reference
from .batched import gemm_batched
from .int32_kernel import gemm_int32, int32_limbs
from .kernel import epilogue_names
from .prepacked import PackedMatrix, gemm_packed, gemm_prepack_a, gemm_prepack_b
from .tiling import GemmTiles, plan_tiles

__all__ = ["gemm", "gemm_ad", "gemm_batched", "gemm_int32", "gemm_reference", "gemm_strided",
           "int32_limbs", "linear", "linear_reference", "epilogue_names", "gemm_packed",
           "gemm_prepack_a", "gemm_prepack_b", "PackedMatrix", "GemmTiles", "plan_tiles"]
