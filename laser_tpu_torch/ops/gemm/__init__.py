from .api import gemm, gemm_reference
from .autodiff import gemm_ad, linear, linear_reference

__all__ = ["gemm", "gemm_ad", "gemm_reference", "linear", "linear_reference"]
