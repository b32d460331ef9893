"""The GEMM kernels' route names against the CUDA launchers' codes, and the
route argument on the CPU (where every route runs the plain version).

``gemm_fused(route=...)`` and ``gemm_w4(route=...)`` pass a code to
csrc/gemm.cu (``enum Route``) and csrc/w4_gemm.cu (``enum W4Route``); each
launcher reports the route it took by that code and the wrapper counts the
launch on ``ROUTE_KERNELS[code]``. A code out of step with its enum would
count launches on the wrong kernel, which only a card would run into: these
tests read the enums from the sources. Tolerance of the CPU products: the
plain versions are the same computation, so equal bits.
"""

import re

import numpy as np
import pytest
import torch

from laser_tpu_torch import registry
from laser_tpu_torch.ops.gemm import int4_kernel, kernel


def _enum(source: str, name: str) -> dict:
    text = (registry.CSRC_DIR / source).read_text()
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return {k.strip(): int(v) for k, v in (e.split("=") for e in body.split(","))}


def test_route_codes_match_the_launchers():
    for source, enum, module in (("gemm.cu", "Route", kernel),
                                 ("w4_gemm.cu", "W4Route", int4_kernel)):
        codes = _enum(source, enum)
        assert sorted(codes.values()) == sorted(module.ROUTES.values()), source
        assert module.ROUTES[None] == 0 and min(codes.values()) == 0
        # each launch-reporting code has its own counter on the kernel's source
        assert sorted(module.ROUTE_KERNELS) == sorted(v for v in codes.values() if v)
        names = {k.name for k in module.ROUTE_KERNELS.values()}
        assert len(names) == len(module.ROUTE_KERNELS)
        assert all(k.source.endswith(source) for k in module.ROUTE_KERNELS.values())


def test_routes_on_the_cpu_run_the_plain_version():
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(8, 96).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.randn(96, 40).astype(np.float32)).bfloat16()
    want = kernel.gemm_plain(a, b, epilogue="gelu")
    for route in kernel.ROUTES:
        assert torch.equal(kernel.gemm_fused(a, b, epilogue="gelu", route=route), want)
    wq = int4_kernel.quantize_int4(b.float(), group=32)
    want = int4_kernel.gemm_w4_plain(a, wq)
    for route in int4_kernel.ROUTES:
        assert torch.equal(int4_kernel.gemm_w4(a, wq, route=route), want)
    with pytest.raises(ValueError):
        kernel.gemm_fused(a, b, route="gemv")
    with pytest.raises(ValueError):
        int4_kernel.gemm_w4(a, wq, route="gemv")
