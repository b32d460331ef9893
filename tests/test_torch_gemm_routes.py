"""The GEMM and conv kernels' route names against the CUDA launchers'
codes, and the route argument on the CPU (where every route runs the plain
version).

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
from laser_tpu_torch.ops import conv
from laser_tpu_torch.ops.gemm import int4_kernel, kernel, prepacked


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


@pytest.mark.parametrize("source,module", [("conv.cu", conv), ("packed_gemm.cu", prepacked)])
def test_conv_and_packed_route_codes_match_the_launchers(source, module):
    """csrc/conv.cu's and csrc/packed_gemm.cu's ``enum Route`` against
    ``conv.ROUTES`` and ``prepacked.ROUTES``, each code with its counter."""
    codes = _enum(source, "Route")
    assert sorted(codes.values()) == sorted(module.ROUTES.values())
    assert module.ROUTES[None] == 0 and min(codes.values()) == 0
    assert sorted(module.ROUTE_KERNELS) == sorted(v for v in codes.values() if v)
    assert len({k.name for k in module.ROUTE_KERNELS.values()}) == len(module.ROUTE_KERNELS)
    assert all(k.source.endswith(source) for k in module.ROUTE_KERNELS.values())


def test_conv_and_packed_routes_on_the_cpu_run_the_plain_version():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 8, 11, 9).astype(np.float32))
    w = torch.from_numpy(rng.randn(6, 8, 3, 3).astype(np.float32))
    want = conv.conv2d_direct_reference(x, w, (1, 1), (2, 1))
    for route in conv.ROUTES:
        assert torch.equal(conv.conv_direct(x, w, (1, 1), (2, 1), route=route), want)
    with pytest.raises(ValueError):
        conv.conv_direct(x, w, route="wgmma")
    with pytest.raises(ValueError):
        conv.conv2d_direct(x, w, route="wgmma")
    a = torch.from_numpy(rng.randn(20, 30).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.randn(30, 12).astype(np.float32)).bfloat16()
    pa, pb = prepacked.gemm_prepack_a(a), prepacked.gemm_prepack_b(b)
    want = prepacked.gemm_packed(0.5, pa, pb)
    for route in prepacked.ROUTES:
        assert torch.equal(prepacked.gemm_packed(0.5, pa, pb, route=route), want)
    with pytest.raises(ValueError):
        prepacked.gemm_packed(0.5, pa, pb, route="mma")


def test_simt_routes_have_their_own_counters():
    """The simt routes' codes in csrc/gemm.cu and csrc/packed_gemm.cu, their
    counters (a batched f32 launch counts on ``gemm_simt``, the kernel it
    runs), and the skeleton's tile against the planner's f32 CTA."""
    from laser_tpu_torch.ops.gemm import batched, tiling

    assert _enum("gemm.cu", "Route")["kRouteSimt"] == kernel.ROUTES["simt"]
    assert _enum("packed_gemm.cu", "Route")["kRouteSimt"] == prepacked.ROUTES["simt"]
    simt = kernel.ROUTE_KERNELS[kernel.ROUTES["simt"]]
    assert simt is kernel.GEMM_SIMT and simt.name == "gemm_simt"
    assert batched.ROUTE_KERNELS[kernel.ROUTES["simt"]] is simt
    packed = prepacked.ROUTE_KERNELS[prepacked.ROUTES["simt"]]
    assert packed is prepacked.GEMM_PACKED_SIMT and packed.name == "gemm_packed_simt"
    assert packed.source.endswith("packed_gemm.cu") and simt.source.endswith("gemm.cu")
    for source in ("gemm.cu", "packed_gemm.cu"):
        assert '#include "simt_gemm.cuh"' in (registry.CSRC_DIR / source).read_text()
    text = (registry.CSRC_DIR / "simt_gemm.cuh").read_text()
    tile = tuple(int(re.search(r"\b%s = (\d+)" % k, text).group(1)) for k in ("kBM", "kBN", "kBK"))
    assert tile == prepacked.SIMT_TILE == tiling.CTA[torch.float32]


def test_simt_route_on_the_cpu_runs_the_plain_version():
    """route="simt" on CPU tensors: the plain version's bits, one plain call,
    no launch; a bf16 product asked for simt also runs the plain version
    (the route is checked only where a card launches)."""
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.randn(70, 36).astype(np.float32))
    b = torch.from_numpy(rng.randn(44, 36).astype(np.float32))
    bias = torch.from_numpy(rng.randn(44).astype(np.float32))
    kw = dict(bias=bias, epilogue="relu", transpose_b=True, alpha=0.5, beta=2.0,
              c=torch.ones(70, 44))
    want = kernel.gemm_plain(a, b, **kw)
    before = (kernel.GEMM.plain_calls, kernel.GEMM_SIMT.launches)
    assert torch.equal(kernel.gemm_fused(a, b, route="simt", **kw), want)
    assert (kernel.GEMM.plain_calls, kernel.GEMM_SIMT.launches) == (before[0] + 1, before[1])
    ab, bb = a.bfloat16(), b.bfloat16()
    assert torch.equal(kernel.gemm_fused(ab, bb, transpose_b=True, route="simt"),
                       kernel.gemm_plain(ab, bb, transpose_b=True))


def test_int8_wgmma_routes_have_their_own_counters():
    """csrc/limb_gemm.cu's ``enum Route`` against ``limb_kernel.ROUTES`` and
    ``int32_kernel.ROUTES``, each code with its counter on the kernel's
    source; the int8 GEMM's wgmma code (csrc/gemm.cu) counts on its own
    ``gemm_i8_wgmma``; every int8 wgmma kernel runs the shared skeleton."""
    from laser_tpu_torch.ops.gemm import int32_kernel, limb_kernel

    codes = _enum("limb_gemm.cu", "Route")
    for module, names in ((limb_kernel, ("gemm_limbs", "gemm_limbs_wgmma")),
                          (int32_kernel, ("gemm_int32", "gemm_int32_wgmma"))):
        assert sorted(codes.values()) == sorted(module.ROUTES.values())
        assert module.ROUTES[None] == 0 and codes["kRouteWgmma"] == module.ROUTES["wgmma"]
        assert sorted(module.ROUTE_KERNELS) == sorted(v for v in codes.values() if v)
        assert tuple(module.ROUTE_KERNELS[c].name for c in (1, 2)) == names
        assert all(k.source.endswith("limb_gemm.cu") for k in module.ROUTE_KERNELS.values())
    gemm_codes = _enum("gemm.cu", "Route")
    assert sorted(kernel.I8_ROUTE_KERNELS) == [gemm_codes["kRouteClassic"],
                                               gemm_codes["kRouteWgmma"]]
    assert kernel.I8_ROUTE_KERNELS[gemm_codes["kRouteWgmma"]] is kernel.GEMM_I8_WGMMA
    assert kernel.I8_ROUTE_KERNELS[gemm_codes["kRouteClassic"]] is kernel.GEMM
    for source in ("gemm.cu", "limb_gemm.cu"):
        text = (registry.CSRC_DIR / source).read_text()
        assert '#include "wgmma_gemm.cuh"' in text and "wgmma_gemm<int8_t, false, true>" in text
    assert "m64n128k32.s32.s8.s8" in (registry.CSRC_DIR / "hopper.cuh").read_text()


def test_int8_routes_on_the_cpu_run_the_plain_version():
    """Every route name of the int8 GEMM, the limb product and the int32
    GEMM on CPU tensors: the plain version's bits and no launch; an
    unknown name raises ValueError."""
    from laser_tpu_torch.ops.gemm import int32_kernel, limb_kernel

    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randint(-128, 128, (9, 48)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-128, 128, (48, 7)).astype(np.int8))
    want = kernel.gemm_plain(a, b, alpha=3, epilogue="relu")
    for route in (None, "classic", "wgmma"):
        assert torch.equal(kernel.gemm_fused(a, b, alpha=3, epilogue="relu", route=route), want)
    da = torch.from_numpy(rng.randint(-128, 128, (3, 9, 48)).astype(np.int8))
    db = torch.from_numpy(rng.randint(-128, 128, (5, 48, 7)).astype(np.int8))
    dbt = db.transpose(1, 2).contiguous()
    planes = limb_kernel.gemm_limbs_plain(da, db, 6)
    x = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, (9, 48)).astype(np.int32))
    y = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, (48, 7)).astype(np.int32))
    la, lb = int32_kernel.int32_limbs(x), int32_kernel.int32_limbs(y)
    prod = int32_kernel.gemm_int32_limbs_plain(la, lb, -5, 3, x[:, :7].contiguous())
    counters = [k for m in (kernel, limb_kernel, int32_kernel)
                for k in (m.I8_ROUTE_KERNELS if m is kernel else m.ROUTE_KERNELS).values()]
    before = [k.launches for k in counters]
    for route in limb_kernel.ROUTES:
        assert torch.equal(limb_kernel.gemm_limbs(da, db, 6, route=route), planes)
        assert torch.equal(limb_kernel.gemm_limbs_kmajor(da, dbt, 6, route=route), planes)
        assert torch.equal(int32_kernel.gemm_int32_limbs(la, lb, -5, 3, x[:, :7].contiguous(),
                                                         route=route), prod)
        assert torch.equal(int32_kernel.gemm_int32_limbs_kmajor(
            la, int32_kernel.int32_limbs(y.t()), -5, 3, x[:, :7].contiguous(), route=route),
            prod)
    assert [k.launches for k in counters] == before
    for fn in (lambda: kernel.gemm_fused(a, b, route="mma"),
               lambda: limb_kernel.gemm_limbs(da, db, 6, route="mma"),
               lambda: limb_kernel.gemm_limbs_kmajor(da, dbt, 6, route="mma"),
               lambda: int32_kernel.gemm_int32_limbs(la, lb, route="mma"),
               lambda: int32_kernel.gemm_int32_limbs_kmajor(la, lb.transpose(1, 2),
                                                            route="mma")):
        with pytest.raises(ValueError):
            fn()
