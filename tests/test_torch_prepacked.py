"""laser_tpu_torch's prepacked GEMM and block planner against laser_tpu's.

The port's wrapper takes its plain version here (CPU tensors); laser_tpu
runs its Pallas packed kernel in interpret mode. Tolerances: packed bytes
identical for the same plan; f32 products within 1e-5 of max |laser_tpu|
(summation order only: laser_tpu sums each block product at HIGHEST
precision, the port per k-block in fp32), bf16 within 2^-7 of it (one bf16
output rounding apart), int8 -> int32 and the golden cases exact.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_gemm_golden import FLOAT_CASES

import laser_tpu as lt
from laser_tpu.ops.gemm import GemmTiles as JTiles
from laser_tpu.ops.gemm import plan_tiles as jplan_tiles
from laser_tpu_torch.config import config_override
from laser_tpu_torch.convert import packed_from_numpy
from laser_tpu_torch.ops import gemm as G
from laser_tpu_torch.ops.gemm import prepacked, tiling

M, N, K = 100, 120, 90  # laser_tpu's test shape (tests/test_gemm.py TestPrepacked)
ODD = (48, 80, 40)      # a plan off the port's CTA tile: the kernel's gather route
TILES_128 = dict(bm=128, bn=128, bk=128, vmem_limit_bytes=1 << 24)


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x):
    """The bytes of a packed array or tensor, as uint8."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _operands(dtype, seed, m=M, n=N, k=K):
    rng = np.random.RandomState(seed)
    if dtype == np.int8:
        return (rng.randint(-128, 128, (m, k)).astype(np.int8),
                rng.randint(-128, 128, (k, n)).astype(np.int8))
    return np.asarray(rng.randn(m, k), dtype), np.asarray(rng.randn(k, n), dtype)


def _both(a, b, tiles):
    """(laser_tpu's packed A, B), (the port's) for one plan."""
    jt, tt = JTiles(*tiles, vmem_limit_bytes=1 << 24), G.GemmTiles(*tiles, vmem_limit_bytes=0)
    return ((lt.gemm_prepack_a(jnp.asarray(a), tiles=jt), lt.gemm_prepack_b(jnp.asarray(b),
                                                                             tiles=jt)),
            (G.gemm_prepack_a(_t(a), tiles=tt), G.gemm_prepack_b(_t(b), tiles=tt)))


@pytest.mark.parametrize("tiles", [ODD, (128, 128, 64)])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int8])
def test_packed_bytes_equal_laser_tpu(dtype, tiles):
    a, b = _operands(dtype, 1)
    (ja, jb), (pa, pb) = _both(a, b, tiles)
    for mine, ref in ((pa, ja), (pb, jb)):
        assert tuple(mine.data.shape) == tuple(ref.data.shape)
        assert mine.grid_shape == tuple(ref.grid_shape)
        assert (mine.rows, mine.cols, mine.block, mine.operand) == (
            ref.rows, ref.cols, tuple(ref.block), ref.operand)
        np.testing.assert_array_equal(_bits(mine.data), _bits(ref.data))


@pytest.fixture(scope="module")
def f32_case():
    """laser_tpu's test shape: its result on its own plan and on the odd
    plan, with alpha 0.5 and beta * C."""
    a, b = _operands(np.float32, 2)
    c = np.random.RandomState(3).randn(M, N).astype(np.float32)
    jt = jplan_tiles(M, N, K, np.float32)
    out = {}
    for name, tiles in (("laser_plan", (jt.bm, jt.bn, jt.bk)), ("odd", ODD)):
        (ja, jb), _ = _both(a, b, tiles)
        out[name] = (tiles, np.asarray(lt.gemm_packed(0.5, ja, jb, -1.5, jnp.asarray(c))))
    return a, b, c, out


@pytest.mark.parametrize("plan", ["laser_plan", "odd", "port_plan"])
def test_f32_alpha_beta_c_vs_laser_tpu(f32_case, plan):
    a, b, c, runs = f32_case
    tiles, want = runs["odd" if plan == "odd" else "laser_plan"]
    t = None if plan == "port_plan" else G.GemmTiles(*tiles, vmem_limit_bytes=0)
    pa, pb = G.gemm_prepack_a(_t(a), tiles=t, n_hint=N), G.gemm_prepack_b(_t(b), tiles=t,
                                                                          m_hint=M)
    got = G.gemm_packed(0.5, pa, pb, -1.5, _t(c))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_reuse_across_multiplies_vs_laser_tpu():
    """tests/test_gemm.py's reuse case: B packed once, A of two heights."""
    k, n = 64, 80
    rng = np.random.RandomState(4)
    b = rng.randn(k, n).astype(np.float32)
    jb = lt.gemm_prepack_b(jnp.asarray(b), tiles=JTiles(**TILES_128))
    pb = G.gemm_prepack_b(_t(b), tiles=G.GemmTiles(**TILES_128))
    for m in (32, 64):
        a = rng.randn(m, k).astype(np.float32)
        want = np.asarray(lt.gemm_packed(1.0, lt.gemm_prepack_a(jnp.asarray(a),
                                                                tiles=JTiles(**TILES_128)), jb))
        got = G.gemm_packed(1.0, G.gemm_prepack_a(_t(a), tiles=G.GemmTiles(**TILES_128)), pb)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        assert np.abs(got.numpy() - a.astype(np.float64) @ b).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", FLOAT_CASES[:2])
def test_golden_exact(case):
    """tests/test_gemm_golden.py's prepacked cases: exact."""
    a, b, want = (np.asarray(x, np.float32) for x in case)
    t = G.GemmTiles(**TILES_128)
    got = G.gemm_packed(1.0, G.gemm_prepack_a(_t(a), tiles=t), G.gemm_prepack_b(_t(b), tiles=t),
                        0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_within_one_rounding_of_laser_tpu():
    a, b = _operands(ml_dtypes.bfloat16, 5)
    (ja, jb), (pa, pb) = _both(a, b, (128, 128, 64))
    want = np.asarray(lt.gemm_packed(1.0, ja, jb)).astype(np.float32)
    got = G.gemm_packed(1.0, pa, pb)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("alpha,beta", [(3, -2), (0.5, 1)])
def test_int8_to_int32_exact_vs_laser_tpu(alpha, beta):
    """int32 accumulator, alpha and beta cast to int32 (0.5 -> 0), beta * C
    wrapping; the odd plan."""
    a, b = _operands(np.int8, 6)
    c = np.random.RandomState(7).randint(-2**31, 2**31 - 1, (M, N)).astype(np.int32)
    (ja, jb), (pa, pb) = _both(a, b, ODD)
    want = np.asarray(lt.gemm_packed(alpha, ja, jb, beta, jnp.asarray(c)))
    got = G.gemm_packed(alpha, pa, pb, beta, _t(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_from_numpy_round_trips():
    a, b = _operands(np.float32, 8)
    (ja, jb), (pa, pb) = _both(a, b, ODD)
    ca = packed_from_numpy(np.asarray(ja.data), ja.rows, ja.cols, ja.block, ja.operand,
                           device="cpu")
    cb = packed_from_numpy(np.asarray(jb.data), jb.rows, jb.cols, jb.block, jb.operand,
                           device="cpu")
    for mine, conv in ((pa, ca), (pb, cb)):
        assert torch.equal(mine.data, conv.data)
        assert (mine.rows, mine.cols, mine.block, mine.operand) == (
            conv.rows, conv.cols, conv.block, conv.operand)
    assert torch.equal(G.gemm_packed(1.0, ca, cb), G.gemm_packed(1.0, pa, pb))
    with pytest.raises(ValueError):
        packed_from_numpy(np.asarray(ja.data), ja.rows, ja.cols, (1, 2), "A", device="cpu")


def test_value_errors_as_laser_tpu():
    a, b = _operands(np.float32, 9)
    t = G.GemmTiles(*ODD, vmem_limit_bytes=0)
    pa, pb = G.gemm_prepack_a(_t(a), tiles=t), G.gemm_prepack_b(_t(b), tiles=t)
    with pytest.raises(ValueError, match="packed A, packed B"):
        G.gemm_packed(1.0, pb, pa)
    with pytest.raises(ValueError, match="K mismatch"):
        G.gemm_packed(1.0, pa, G.gemm_prepack_b(_t(b[:50]), tiles=t))
    with pytest.raises(ValueError, match="bk"):
        G.gemm_packed(1.0, pa, G.gemm_prepack_b(_t(b), tiles=G.GemmTiles(48, 80, 30, 0)))
    with pytest.raises(NotImplementedError, match="queue 1"):
        pf = G.gemm_prepack_a(_t(a), tiles=t, dtype=torch.float64)
        G.gemm_packed(1.0, pf, G.gemm_prepack_b(_t(b), tiles=t, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="queue 1"):
        G.gemm_packed(1.0, pa, pb, acc_dtype=torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
def test_plan_tiles_fits_the_kernel(dtype):
    t = G.plan_tiles(4096, 4096, 4096, dtype)
    cm, cn, ck = tiling.CTA[dtype]
    assert t.bm % cm == 0 and t.bn % cn == 0 and t.bk % ck == 0
    assert 4096 % t.bk == 0  # no K padding at bench.py's shape
    assert tiling.stage_bytes(dtype, t.bk) <= tiling.smem_per_block() // 2
    assert prepacked.blocks_route(dtype, t.bm, t.bn, t.bk)
    assert t.grid(4096, 4096, 4096) == (4096 // t.bm, 4096 // t.bn, 4096 // t.bk)
    assert not prepacked.blocks_route(dtype, *ODD)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_planned_16bit_plan_takes_the_wgmma_route(dtype):
    """csrc/packed_gemm.cu's wgmma predicate: the planned plan at bench.py's
    4096^3 and at laser_tpu's odd test shape takes it; the ODD plan and f32
    do not (int8 takes its own wgmma route: the tests below)."""
    for m, n, k in ((4096, 4096, 4096), (M, N, K)):
        t = G.plan_tiles(m, n, k, dtype)
        assert prepacked.wgmma_route(dtype, t.bm, t.bn, t.bk)
    assert not prepacked.wgmma_route(dtype, *ODD)
    t = G.plan_tiles(4096, 4096, 4096, torch.float32)
    assert not prepacked.wgmma_route(torch.float32, t.bm, t.bn, t.bk)


def test_plan_tiles_overrides_and_config():
    """``overrides`` and the config's gemm_bm/bn/bk replace planned sizes,
    rounded up to the CTA tile; laser_tpu's plan object builds here."""
    t = G.plan_tiles(1000, 1000, 1000, np.float32, overrides=(200, None, 40))
    assert (t.bm, t.bn, t.bk) == (256, 128, 48)
    with config_override(gemm_bm=None, gemm_bn=300, gemm_bk=None):
        assert G.plan_tiles(1000, 1000, 1000, torch.bfloat16).bn == 384
    assert G.GemmTiles(**TILES_128).grid(300, 100, 129) == (3, 1, 2)


@pytest.mark.parametrize("dtype,plan,want", [
    (torch.float32, (128, 128, 32), True), (torch.float32, ODD, False),
    (torch.bfloat16, (128, 128, 32), False), (torch.float32, (256, 384, 16), True),
    (torch.float32, (128, 128, 8), False), (torch.int8, (128, 128, 64), False)])
def test_simt_route_predicate(dtype, plan, want):
    """csrc/packed_gemm.cu's simt predicate: f32, bm and bn multiples of 128,
    bk of 16 (``prepacked.SIMT_TILE``)."""
    assert prepacked.simt_route(dtype, *plan) is want


@pytest.mark.parametrize("shape", [(4096, 4096, 4096), (M, N, K), (1, 1, 1), (300, 70, 4000)])
def test_planned_f32_plan_takes_the_simt_route(shape):
    """Every f32 plan ``plan_tiles`` makes (``tiling.CTA[float32]`` is
    (128, 128, 16)) takes the simt route, and none takes wgmma."""
    t = G.plan_tiles(*shape, torch.float32)
    assert prepacked.simt_route(torch.float32, t.bm, t.bn, t.bk)
    assert not prepacked.wgmma_route(torch.float32, t.bm, t.bn, t.bk)
    assert tiling.CTA[torch.float32] == prepacked.SIMT_TILE


@pytest.mark.parametrize("route", ["simt", "classic"])
def test_f32_routes_on_the_cpu_vs_laser_tpu(f32_case, route):
    """route="simt" and "classic" on CPU operands run the plain version:
    laser_tpu's result on its own plan within 1e-5, and the same bits as
    the route the library picks."""
    from laser_tpu_torch.ops.gemm.prepacked import GEMM_PACKED, GEMM_PACKED_SIMT

    a, b, c, runs = f32_case
    tiles, want = runs["laser_plan"]
    t = G.GemmTiles(*tiles, vmem_limit_bytes=0)
    pa, pb = G.gemm_prepack_a(_t(a), tiles=t), G.gemm_prepack_b(_t(b), tiles=t)
    before = (GEMM_PACKED.plain_calls, GEMM_PACKED_SIMT.launches)
    got = G.gemm_packed(0.5, pa, pb, -1.5, _t(c), route=route)
    assert (GEMM_PACKED.plain_calls, GEMM_PACKED_SIMT.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, G.gemm_packed(0.5, pa, pb, -1.5, _t(c)))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("plan,want", [
    ((128, 128, 128), True), ((256, 384, 256), True), ((128, 128, 64), False),
    ((64, 64, 64), False), ((128, 256, 32), False), ((384, 64, 128), False), (ODD, False)])
def test_int8_wgmma_route_predicate(plan, want):
    """csrc/packed_gemm.cu's int8 wgmma predicate (``wgmma_i8_fits``): bm, bn
    and bk multiples of 128 (``prepacked.WGMMA_I8_TILE``); the classic int8
    kernel's blocks route takes multiples of its 64 x 64 tile."""
    assert prepacked.wgmma_route(torch.int8, *plan) is want
    assert prepacked.blocks_route(torch.int8, *plan) is all(x % 64 == 0 for x in plan)


@pytest.mark.parametrize("shape", [(4096, 4096, 4096), (M, N, K), (1, 1, 1), (300, 70, 4000)])
def test_planned_int8_plan_takes_the_wgmma_route(shape):
    """Every int8 plan ``plan_tiles`` makes (``tiling.CTA[int8]`` is the
    route's (128, 128, 128)) takes the int8 wgmma route, and the classic
    kernel's blocks route where it is asked for; none takes simt."""
    t = G.plan_tiles(*shape, torch.int8)
    assert prepacked.wgmma_route(torch.int8, t.bm, t.bn, t.bk)
    assert prepacked.blocks_route(torch.int8, t.bm, t.bn, t.bk)
    assert not prepacked.simt_route(torch.int8, t.bm, t.bn, t.bk)
    assert tiling.CTA[torch.int8] == prepacked.WGMMA_I8_TILE


@pytest.fixture(scope="module")
def int8_planned():
    """laser_tpu's int8 -> int32 product on the port's planned int8 plan
    (alpha 3, beta -2, C over the whole int32 range), once."""
    a, b = _operands(np.int8, 10)
    c = np.random.RandomState(11).randint(-2**31, 2**31 - 1, (M, N)).astype(np.int32)
    t = G.plan_tiles(M, N, K, torch.int8)
    plan = (t.bm, t.bn, t.bk)
    (ja, jb), (pa, pb) = _both(a, b, plan)
    want = np.asarray(lt.gemm_packed(3, ja, jb, -2, jnp.asarray(c)))
    return c, plan, (ja, jb), (pa, pb), want


def test_int8_kmajor_twin_bytes(int8_planned):
    """An int8 B keeps laser_tpu's packed bytes in ``data``; its K-major
    twin is the same blocks transposed, contiguous. Packing makes the twin
    only on CUDA, for int8 blocks the int8 wgmma route reads (bk and bn
    multiples of 128): on the CPU, where the plain version runs, and for A
    or other dtypes and plans, none; ``packed_from_numpy`` does the same."""
    from laser_tpu_torch.ops.gemm.prepacked import kmajor_twin, kmajor_wanted

    _, plan, (ja, jb), (pa, pb), _ = int8_planned
    np.testing.assert_array_equal(_bits(pb.data), _bits(jb.data))
    np.testing.assert_array_equal(_bits(pa.data), _bits(ja.data))
    gk, gn, bk, bn = pb.data.shape
    twin = kmajor_twin(pb.data)
    assert tuple(twin.shape) == (gk, gn, bn, bk) and twin.is_contiguous()
    assert twin.dtype == torch.int8
    assert torch.equal(twin, pb.data.transpose(-1, -2))
    np.testing.assert_array_equal(_bits(twin.transpose(-1, -2)), _bits(jb.data))
    assert kmajor_wanted(torch.int8, bk, bn)
    for dtype, bk_, bn_ in ((torch.int8, 64, 128), (torch.int8, 128, 64),
                            (torch.int8, 40, 80), (torch.bfloat16, 128, 128)):
        assert not kmajor_wanted(dtype, bk_, bn_)
    assert pb.kmajor is None and pa.kmajor is None
    assert G.gemm_prepack_b(torch.ones(K, N), tiles=G.GemmTiles(*plan, 0)).kmajor is None
    cb = packed_from_numpy(np.asarray(jb.data), jb.rows, jb.cols, jb.block, jb.operand,
                           device="cpu")
    assert cb.kmajor is None and torch.equal(cb.data, pb.data)


@pytest.mark.parametrize("route", [None, "wgmma", "classic"])
def test_int8_routes_on_the_cpu_vs_laser_tpu(int8_planned, route):
    """Every route on int8 CPU operands runs the plain version: laser_tpu's
    int32 result bit for bit, alpha and beta * C wrapping mod 2^32."""
    from laser_tpu_torch.ops.gemm.prepacked import GEMM_PACKED, GEMM_PACKED_I8_WGMMA

    c, _, _, (pa, pb), want = int8_planned
    before = (GEMM_PACKED.plain_calls, GEMM_PACKED_I8_WGMMA.launches)
    got = G.gemm_packed(3, pa, pb, -2, _t(c), route=route)
    assert (GEMM_PACKED.plain_calls, GEMM_PACKED_I8_WGMMA.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
