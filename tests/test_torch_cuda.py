"""laser_tpu_torch CUDA kernels against their plain PyTorch versions on the
card, at odd shapes the serving and training slices do not reach:
transposes, f16, ragged tails, unaligned operands, narrow rows, other head
dims, GQA; the flash stats and backward kernels at S 1-1030 and D 32-256,
the backward's tensor-core route asked for against its FFMA route; the
cross-entropy kernels at V 1, 127 and 8193 with label smoothing; ``ce_bwd``
at ragged widths past its 8192-column tile, at a column offset (Llama-3's
ragged last chunk), unaligned, g = 0 rows exact zeros; the chunked
``lm_cross_entropy`` in both layouts and a small llama train step (with
``remat``) through the kernels against the plain route; the int4
weight GEMM at M 1-300, K 64-4096 and groups 16 and 64; the weight-streaming
routes: split-K at M 1-63 in bf16/f16/f32 with ragged K and N, bias, gelu
and beta * C, the same bits twice, the old kernels taken by shape; the int4
stream and mma routes at M 1-257 and groups 2-128; the flash kernel's
GQA map at groups 1-8; the paged kernel over int8 pages at groups 1-8; the
paged window (verify) kernel at W 1-8, groups 1-8, float and int8 pages;
bursts and speculative decoding in the engine on the card; the planewise
and direct conv kernels at odd channel counts, kernel sizes, paddings and
strides, the direct conv's ffma and mma routes at strides 1, 2 and (3, 2),
ragged pixel tiles, K 65, 180 and 1170 (two tap-table chunks), and the
classic route's phase convs at a stride; both softmax kernels from 1 to 40001 columns, all -inf rows and
``donate``; the register-resident row kernel at widths 1 to 16384 in
f32/bf16/f16, rows at an unaligned offset, 5 and 4099 rows, against the
plain version and the classic kernel; a small CNN and MLP through the kernels; the templates of
csrc/foreach.cuh filled with generated bodies: for_each over bodies of each
vocabulary group in f32/bf16/f16 and integer types, sizes 1 to 151557, with
unaligned operands (the scalar path), donate and for_each_multi; the
vector-math tiers; reduce_* (f32, bf16, int32, sizes 1 and 2^29 + 3) and
row_reduce run twice to the same bits; map_reduce with a custom
combine_fn; Lux's three lowering kinds on the kernels; the transposes of
csrc/transpose.cu at ragged tiles for every element size (1, 2, 4, 8
bytes), in place at N 128, 384 and 8192 and on ragged N; for_each over
strided views (offsets, every k-th row or column, negative strides on each
axis, 1-D, transposed, broadcast; the vector and scalar paths);
map_reduce_staged bodies of reduction depth 1 and 2 on ragged tails, run
twice to the same bits, and argmax / argmin in every dtype; the GEMM dtype
table bit for bit: the int8 GEMM at M 1-130, K 1-4096 in every transpose,
its int32 epilogue (alpha, beta * C, bias, activations, wrapping) and
accumulator wrap (K = 140000), unaligned operands; the batched GEMM in
f32/bf16/f16/int8 and past the grid's 65535 entries; the limb kernel at
1-8 planes, buckets 1-8, K 1-8192 and all-(-128) digits; the int32 kernel
at INT_MIN/MAX with alpha, beta, C and uint32; int64 across its K chunk
and f64 against the CPU route; the int8 wgmma skeleton's three routes
(the int8 GEMM, the limb product, the int32 GEMM) bit for bit against
their plain versions and the WMMA kernels they replace: ragged M and N, K
off 128 and at the int64 / f64 chunk boundaries, every int8 transposition,
alpha, beta * C, bias, every epilogue and output dtype, -128 / 127
operands, the accumulator's wrap, INT_MIN / INT_MAX, planes and buckets
1-8 with nA != nB, more tiles than resident blocks, the routes picked by
shape and the ones that do not fit raising; int8 quantization (per row, global,
stochastic, f32/bf16/f16, 1 x 1 to 4096 x 3) and gemm_quantized; the
library surface bit for bit: the AdamW and SGD-momentum updates in
f32/bf16/f16 from 1 to 1000003 elements, unaligned (the scalar path), lr on
the card, whole trees against the CPU route; SGD's multi-tensor kernel over
trees of three dtypes with unaligned, empty and one-element leaves, past
one launch's table, and captured in a CUDA graph, against the plain
version and the per-leaf kernel; the stencil sweeps in
f32/bf16/f16 on grids from 2 x 5 to 257 x 130; the packed GEMM in
f32/bf16/f16 (within the bounds below) and int8 (bit for bit) on planned,
odd (48 x 80 x 40: the gather route) and wide plans, with beta * C, other
output dtypes and the int8 alpha cast; its bf16/f16 wgmma route on planned
and wide plans at M, N, K off the plan, to f32 and to the input type; the
f32 simt routes (dense in every transposition with each epilogue, beta * C
and bf16 outputs, batched, packed on planned and wide plans) bit for bit
against the classic FFMA kernels, and the f32 routes the library picks by
shape and alignment.

Needs a CUDA device and nvcc; skips without them. This file imports no JAX,
so it runs on a machine that has none. Run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX for the laser_tpu tests).

Tolerance: max |kernel - plain| / max |plain| <= 1e-5 in f32 (summation
order only), 1e-2 in bf16/f16 (one output rounding apart); the templates'
own bounds are stated beside their cases. Outputs that are
zero up to rounding are held against max(max |plain|, 1) instead: at V = 1
the cross-entropy loss and unit gradient, and at S = 1 the attention
gradients dq and dk (the one probability is 1, so ds is zero).
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda

REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, shape, dtype, dev, std=1.0):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _gemm_launches():
    """Launches of the GEMM kernel over its three routes."""
    from laser_tpu_torch.ops.gemm.kernel import ROUTE_KERNELS

    return sum(k.launches for k in ROUTE_KERNELS.values())


def _check(got, want, dtype, floor=1e-30):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), floor)
    assert err <= REL[dtype], err


def _route_launches(counts, family):
    """Launches in ``counts`` of every route of the GEMM (``"gemm"``) or of
    the int4 GEMM (``"w4_gemm"``), none of them a plain call."""
    from laser_tpu_torch.ops.gemm import int4_kernel, kernel

    routes = {"gemm": kernel.ROUTE_KERNELS, "w4_gemm": int4_kernel.ROUTE_KERNELS}[family]
    names = [k.name for k in routes.values()]
    assert all(counts[n]["plain_calls"] == 0 for n in names)
    return sum(counts[n]["launches"] for n in names)


def _check_rows(got, want, dtype):
    """As ``_check``, each output row (last axis) against its own max:
    attention rows over one key and over hundreds differ in size by far
    more than the bound."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = ((got - want).abs().amax(-1) / want.abs().amax(-1).clamp(min=1e-30)).max().item()
    assert err <= REL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("shape,epilogue", [((37, 45, 29), "gelu"), ((130, 200, 72), "relu"),
                                            ((70, 64, 40), "sigmoid"), ((1, 9, 3), "tanh")])
def test_gemm(dev, dtype, ta, tb, shape, epilogue):
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    M, K, N = shape
    g = _gen(dev, 1)
    a = _rnd(g, (K, M) if ta else (M, K), dtype, dev)
    b = _rnd(g, (N, K) if tb else (K, N), dtype, dev, std=K ** -0.5)
    bias = _rnd(g, (N,), dtype, dev)
    kw = dict(bias=bias, epilogue=epilogue, transpose_a=ta, transpose_b=tb)
    before = _gemm_launches()
    _check(gemm_fused(a, b, **kw), gemm_plain(a, b, **kw), dtype)
    assert _gemm_launches() == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_alpha_beta_c_out_dtype(dev, dtype):
    from laser_tpu_torch.ops.gemm import gemm, gemm_reference

    g = _gen(dev, 2)
    a, b = _rnd(g, (66, 130), dtype, dev), _rnd(g, (130, 50), dtype, dev)
    c = _rnd(g, (66, 50), torch.float32, dev)
    kw = dict(alpha=0.5, beta=-2.0, c=c, out_dtype=torch.float32)
    got, want = gemm(a, b, **kw), gemm_reference(a, b, **kw)
    _check(got.to(dtype), want.to(dtype), dtype)


def test_gemm_unaligned_operands(dev):
    """Operands whose data starts 2 bytes off a 16-byte boundary take the
    scalar tile loader."""
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    g = _gen(dev, 3)
    M, K, N = 40, 64, 48
    a = _rnd(g, (M * K + 1,), torch.bfloat16, dev)[1:].view(M, K)
    b = _rnd(g, (K * N + 1,), torch.bfloat16, dev)[1:].view(K, N)
    bias = torch.zeros(N, device=dev, dtype=torch.bfloat16)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _check(gemm_fused(a, b, bias=bias), gemm_plain(a, b, bias=bias), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("gdtype", [None, torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("cols", [1, 33, 200, 1000, 2048, 3000, 4096])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm(dev, dtype, gdtype, cols, kind):
    """One launch a call, gains read in their own dtype: the vec kernel
    where the row is whole 16-byte vectors (at most 1024 of them), else the
    classic kernel; held against the plain version and against the classic
    kernel asked for."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops import norm

    g = _gen(dev, 4)
    x = _rnd(g, (5, 7, cols), dtype, dev, std=3.0) + 1
    gam = None if gdtype is None else _rnd(g, (cols,), gdtype, dev)
    bet = None if gdtype is None else _rnd(g, (cols,), gdtype, dev)
    if kind == "layer":
        run = lambda route=None: norm.layer_norm(x, gam, bet, route=route)  # noqa: E731
        want = norm.layer_norm_reference(x, gam, bet)
    else:
        run = lambda route=None: norm.rms_norm(x, gam, route=route)  # noqa: E731
        want = norm.rms_norm_reference(x, gam)
    registry.reset_counts()
    got = run()
    counts = registry.counts()
    n = 16 // x.element_size()
    vec = cols % n == 0 and cols // n <= 1024
    assert counts["norm_vec"]["launches"] == int(vec)
    assert counts["norm"]["launches"] == int(not vec)
    assert sum(c["launches"] for c in counts.values()) == 1
    _check(got, want, dtype)
    _check(got, run("classic"), dtype)


def test_norm_unaligned_view_and_routes_asked_for(dev):
    """A row view 2 bytes off a 16-byte boundary takes the classic kernel;
    ``route="vec"`` raises there and runs on the aligned rows, "classic"
    runs anywhere, an unknown name raises."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops import norm

    g = _gen(dev, 17)
    buf = _rnd(g, (8 * 2048 + 1,), torch.bfloat16, dev)
    x = buf[1:].view(8, 2048)
    gam, bet = _rnd(g, (2048,), torch.bfloat16, dev), _rnd(g, (2048,), torch.bfloat16, dev)
    registry.reset_counts()
    _check(norm.layer_norm(x, gam, bet), norm.layer_norm_reference(x, gam, bet),
           torch.bfloat16)
    assert registry.counts()["norm"]["launches"] == 1
    with pytest.raises(ValueError, match="vec"):
        norm.layer_norm(x, gam, bet, route="vec")
    xa = x.clone()
    registry.reset_counts()
    _check(norm.rms_norm(xa, gam, route="vec"), norm.rms_norm_reference(xa, gam),
           torch.bfloat16)
    _check(norm.rms_norm(xa, gam, route="classic"), norm.rms_norm_reference(xa, gam),
           torch.bfloat16)
    assert (registry.counts()["norm_vec"]["launches"],
            registry.counts()["norm"]["launches"]) == (1, 1)
    with pytest.raises(ValueError, match="unknown route"):
        norm.layer_norm(xa, route="split")


def _paged_inputs(g, dev, dtype, S, W, Hq, Hkv, hd, ps, mp, quant):
    """q (S, W, Hq, hd), pools of S * mp + 1 pages (int8 with scales when
    ``quant``) and a shuffled table."""
    from laser_tpu_torch.ops.paged_attention import quantize_kv

    P = S * mp + 1
    q = _rnd(g, (S, W, Hq, hd), dtype, dev)
    kp, vp = _rnd(g, (P, Hkv, ps, hd), dtype, dev), _rnd(g, (P, Hkv, ps, hd), dtype, dev)
    kw = {}
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        kw = dict(k_scale=ks, v_scale=vs)
    tables = torch.randperm(P, generator=g, device=dev)[:S * mp].reshape(S, mp).int()
    return q, kp, vp, tables, kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("W,Hq,Hkv", [(1, 4, 4), (1, 8, 2), (1, 8, 1), (5, 4, 4), (5, 8, 2),
                                      (8, 8, 1), (5, 32, 8), (8, 16, 2)])
def test_paged_split_route(dev, dtype, quant, hd, ps, W, Hq, Hkv):
    """The split kernel (decode at W = 1, verify at W 1-8, groups 1-8, G up
    to 64) row by row against the plain version and the classic kernel
    asked for, at lengths 0, exactly W, across a page, across 64-, 128- and
    256-key chunk boundaries, at capacity and two past the table; two calls
    give the same bits, and at W = 1 the decode gives the verify's bits."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.paged_attention import (paged_attention, paged_window_attention,
                                                     paged_window_attention_reference)

    g = _gen(dev, 18)
    mp = 384 // ps  # 384 keys a table row: six 64-key tiles
    q, kp, vp, tables, kw = _paged_inputs(g, dev, dtype, 7, W, Hq, Hkv, hd, ps, mp, quant)
    cap = mp * ps
    lengths = torch.tensor([0, W, ps + W // 2 + 1, 130, 257, cap, cap + 2], device=dev,
                           dtype=torch.int32)
    registry.reset_counts()
    got = paged_window_attention(q, kp, vp, tables, lengths, **kw)
    again = paged_window_attention(q, kp, vp, tables, lengths, **kw)
    assert registry.counts()["paged_window_attention_split"]["launches"] == 2
    assert registry.counts()["paged_window_attention"]["launches"] == 0
    _check_rows(got, paged_window_attention_reference(q, kp, vp, tables, lengths, **kw), dtype)
    _check_rows(got, paged_window_attention(q, kp, vp, tables, lengths, route="classic", **kw),
                dtype)
    assert registry.counts()["paged_window_attention"]["launches"] == 1
    assert torch.equal(got, again)
    assert (got[0] == 0).all()
    if W == 1:
        dec = paged_attention(q[:, 0], kp, vp, tables, lengths, **kw)
        assert registry.counts()["paged_attention_split"]["launches"] == 1
        assert torch.equal(dec, got[:, 0])
        _check_rows(dec, paged_attention(q[:, 0], kp, vp, tables, lengths, route="classic",
                                         **kw), dtype)
        assert registry.counts()["paged_attention"]["launches"] == 1


def test_paged_routes_asked_for(dev):
    """route="split" raises where it does not fit (f32 q, hd 256, a pool off
    a 16-byte boundary), which route=None sends to the classic kernel;
    route="classic" runs the classic kernels on 16-bit q; an unknown name
    raises."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_reference,
                                                     paged_window_attention)

    g = _gen(dev, 19)
    lengths = torch.tensor([5, 40, 0], device=dev, dtype=torch.int32)
    for dtype, hd in ((torch.float32, 128), (torch.bfloat16, 256)):
        q, kp, vp, tables, _ = _paged_inputs(g, dev, dtype, 3, 1, 4, 2, hd, 16, 4, False)
        with pytest.raises(ValueError, match="split"):
            paged_attention(q[:, 0], kp, vp, tables, lengths, route="split")
        with pytest.raises(ValueError, match="split"):
            paged_window_attention(q, kp, vp, tables, lengths, route="split")
    q, kp, vp, tables, _ = _paged_inputs(g, dev, torch.bfloat16, 3, 1, 4, 2, 64, 16, 4, False)
    off = torch.cat([kp.flatten(), kp.flatten()[:1]])[1:].view(kp.shape)  # 2 bytes off
    registry.reset_counts()
    _check_rows(paged_attention(q[:, 0], off, vp, tables, lengths),
                paged_attention_reference(q[:, 0], off, vp, tables, lengths), torch.bfloat16)
    assert registry.counts()["paged_attention"]["launches"] == 1
    with pytest.raises(ValueError, match="split"):
        paged_attention(q[:, 0], off, vp, tables, lengths, route="split")
    registry.reset_counts()
    paged_attention(q[:, 0], kp, vp, tables, lengths, route="classic")
    paged_window_attention(q, kp, vp, tables, lengths, route="classic")
    counts = registry.counts()
    assert (counts["paged_attention"]["launches"], counts["paged_window_attention"]["launches"],
            counts["paged_attention_split"]["launches"]) == (1, 1, 0)
    with pytest.raises(ValueError, match="unknown route"):
        paged_attention(q[:, 0], kp, vp, tables, lengths, route="mma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 200, 256])
@pytest.mark.parametrize("S", [1, 17, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(dev, dtype, D, S, causal):
    from laser_tpu_torch.ops.attention import attention, attention_reference

    g = _gen(dev, 5)
    q, k, v = (_rnd(g, (2, 3, S, D), dtype, dev) for _ in range(3))
    _check(attention(q, k, v, causal=causal), attention_reference(q, k, v, causal=causal),
           dtype)


DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _flash_bwd_launches():
    """(dq, dk/dv) launches of the flash backward over both routes."""
    from laser_tpu_torch.ops.attention_bwd import ROUTE_KERNELS

    return tuple(sum(pair[i].launches for pair in ROUTE_KERNELS.values()) for i in (0, 1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("S", [1, 45, 300, 1030])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_stats_and_backward(dev, dtype, D, S, causal):
    from laser_tpu_torch.ops.attention import FLASH, FLASH_MMA, flash_forward
    from laser_tpu_torch.ops.attention_bwd import (flash_attention_bwd,
                                                   flash_attention_bwd_reference)

    g = _gen(dev, 8)
    q, k, v, do = (_rnd(g, (3, S, D), dtype, dev) for _ in range(4))
    scale = D ** -0.5
    before = (FLASH.launches + FLASH_MMA.launches, *_flash_bwd_launches())
    o, m, l = flash_forward(q, k, v, causal, scale, stats=True)
    po, pm, pl = flash_forward(q, k, v, causal, scale, stats=True, plain=True)
    _check(o, po, dtype)
    _check(m, pm, torch.float32)
    _check(l, pl, torch.float32)
    got = flash_attention_bwd(q, k, v, o, m, l, do, causal=causal, scale=scale)
    want = flash_attention_bwd_reference(q, k, v, o, m, l, do, causal=causal, scale=scale)
    for name, a, b in zip("qkv", got, want):
        _check(a, b, dtype, floor=1.0 if S == 1 and name in "qk" else 1e-30)
    assert (FLASH.launches + FLASH_MMA.launches, *_flash_bwd_launches()) == \
        tuple(n + 1 for n in before)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,V", [(1, 1), (37, 127), (129, 8193), (300, 2048)])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_cross_entropy_kernels(dev, dtype, T, V, eps):
    from laser_tpu_torch.ops import loss

    g = _gen(dev, 9)
    x = _rnd(g, (T, V), dtype, dev, std=4.0)
    t = torch.randint(0, V, (T,), generator=g, device=dev)
    before = (loss.CE_FWD.launches, loss.CE_FUSED_GRAD.launches)
    floor = 1.0 if V == 1 else 1e-30  # at V = 1 the loss and dxu are zero
    lo, lse = loss.ce_fwd(x, t, eps)
    want = loss.ce_rows_plain(x, t, eps)
    _check(lo, want, torch.float32, floor)
    _check(lse, torch.logsumexp(x.float(), dim=-1), torch.float32)
    lo2, dxu = loss.ce_fused_grad(x, t, eps)
    wlo, wdxu = loss.ce_fused_grad_plain(x, t, eps)
    _check(lo2, wlo, torch.float32, floor)
    _check(dxu, wdxu, dtype, floor)
    assert (loss.CE_FWD.launches, loss.CE_FUSED_GRAD.launches) == \
        (before[0] + 1, before[1] + 1)


def test_cross_entropy_unaligned_rows(dev):
    """Rows that start off a 16-byte boundary take the element-wise path."""
    from laser_tpu_torch.ops import loss

    g = _gen(dev, 10)
    x = _rnd(g, (7 * 64 + 1,), torch.bfloat16, dev)[1:].view(7, 64)
    t = torch.randint(0, 64, (7,), generator=g, device=dev)
    assert x.data_ptr() % 16
    _check(loss.ce_fwd(x, t, 0.0)[0], loss.ce_rows_plain(x, t, 0.0), torch.float32)
    _check(loss.ce_fused_grad(x, t, 0.0)[1], loss.ce_fused_grad_plain(x, t, 0.0)[1],
           torch.bfloat16)


def test_train_step_through_the_kernels(dev):
    """A small f32 train step on the card: every training kernel launches, no
    plain version runs, and the loss and gradients equal the plain route's."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.models import transformer as tf
    from laser_tpu_torch.ops.optim import tree_leaves, value_and_grad

    params = tf.init_transformer(4, n_layers=2, d_model=128, n_heads=2, d_ff=256, vocab=300,
                                 device=dev)
    tokens = torch.randint(0, 300, (2, 33), generator=_gen(dev, 11), device=dev)
    registry.reset_counts()
    loss, grads = value_and_grad(lambda p, t: tf.transformer_lm_loss(p, t, n_heads=2))(
        params, tokens)
    counts = registry.counts()
    for name in ("norm_vec", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "ce_fused_grad"):
        assert counts[name]["launches"] > 0 and counts[name]["plain_calls"] == 0, name
    # f32: the tensor-core routes of the backward do not take it
    for name in ("flash_attention_bwd_dq_mma", "flash_attention_bwd_dkv_mma"):
        assert counts[name] == {"launches": 0, "plain_calls": 0}, name
    assert _route_launches(counts, "gemm") > 0
    ploss, pgrads = value_and_grad(lambda p, t: tf.transformer_lm_loss(
        p, t, n_heads=2, plain=True))(params, tokens)
    assert abs(loss.item() - ploss.item()) <= 1e-5 * abs(ploss.item())
    # the gradients take different routes (the backward kernels against
    # autograd of the plain forward): 1e-4 of each leaf's largest element
    for a, b in zip(tree_leaves(grads), tree_leaves(pgrads)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


# ce_bwd against its plain version: f32 exp and the same fp32 arithmetic,
# 1e-6; 16-bit outputs one rounding of the largest element apart
CE_BWD_REL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _ce_bwd_inputs(g, T, W, c0, V, dtype, dev):
    x = _rnd(g, (T, W), dtype, dev, std=4.0)
    t = torch.randint(c0, c0 + W, (T,), generator=g, device=dev)
    t[::3] = torch.randint(0, V, (len(t[::3]),), generator=g, device=dev)
    # a chunk's lse is at most the whole row's: p stays below 1
    lse = torch.logsumexp(x.float(), dim=-1) + torch.rand(T, generator=g, device=dev)
    gr = torch.randn(T, generator=g, device=dev)
    gr[T // 2] = 0.0  # an ignore_index row
    return x, t, lse, gr


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,W,c0,V", [(1, 1, 0, 1), (37, 127, 0, 127), (129, 8193, 0, 8193),
                                      (64, 300, 1000, 1300), (3, 20000, 0, 20000),
                                      (9, 5376, 122880, 128256)])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_ce_bwd(dev, dtype, T, W, c0, V, eps):
    from laser_tpu_torch.ops import loss

    x, t, lse, gr = _ce_bwd_inputs(_gen(dev, 12), T, W, c0, V, dtype, dev)
    before = loss.CE_BWD.launches
    got = loss.ce_bwd(x, t, lse, gr, eps, c0=c0, V=V)
    want = loss.ce_bwd_plain(x, t, lse, gr, eps, c0=c0, V=V)
    torch.cuda.synchronize()
    assert loss.CE_BWD.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= CE_BWD_REL[dtype] * max(want.float().abs().max().item(), 1e-30), err
    assert torch.count_nonzero(got[T // 2]) == 0


def test_ce_bwd_unaligned_rows(dev):
    """Rows off a 16-byte boundary, or a width that is not a multiple of the
    vector, take the element-wise path."""
    from laser_tpu_torch.ops import loss

    g = _gen(dev, 14)
    x = _rnd(g, (7 * 64 + 1,), torch.bfloat16, dev)[1:].view(7, 64)
    assert x.data_ptr() % 16
    _, t, lse, gr = _ce_bwd_inputs(g, 7, 64, 0, 64, torch.bfloat16, dev)
    for eps in (0.0, 0.1):
        _check(loss.ce_bwd(x, t, lse, gr, eps), loss.ce_bwd_plain(x, t, lse, gr, eps),
               torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transb", [True, False])
def test_lm_cross_entropy_chunked(dev, dtype, transb):
    """The chunked branch through ce_bwd (and, for bf16, the GEMM kernel)
    against its plain route: V 1000 in chunks of 256, the last 232 wide."""
    from laser_tpu_torch.ops import loss
    g = _gen(dev, 13)
    T, D, V = 77, 96, 1000
    h = _rnd(g, (T, D), dtype, dev).requires_grad_(True)
    emb = _rnd(g, (V, D) if transb else (D, V), dtype, dev, std=0.3).requires_grad_(True)
    t = torch.randint(0, V, (T,), generator=g, device=dev)
    t[:5] = 3
    kw = dict(transb=transb, label_smoothing=0.1, ignore_index=3, memory_budget_bytes=None,
              block_v=256)
    before = (loss.CE_BWD.launches, _gemm_launches())
    lk = loss.lm_cross_entropy(h, emb, t, **kw)
    dk = torch.autograd.grad(lk, (h, emb))
    torch.cuda.synchronize()
    gemms = 4 * 4 if dtype == torch.bfloat16 else 0  # 4 chunks: 1 forward, 3 backward
    assert (loss.CE_BWD.launches, _gemm_launches()) == (
        before[0] + 4, before[1] + gemms)
    lp = loss.lm_cross_entropy(h, emb, t, plain=True, **kw)
    dp = torch.autograd.grad(lp, (h, emb))
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    for a, b in zip(dk, dp):
        _check(a, b, dtype)


def test_llama_train_step_through_the_kernels(dev):
    """A small f32 llama loss and gradients on the card, the loss through
    the chunked branch: every kernel of the path launches, no plain version
    runs, the loss and gradients equal the plain route's; with remat the
    same gradients, one more flash forward and two more norms a block."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.models import llama
    from laser_tpu_torch.ops.optim import tree_leaves, value_and_grad

    params = llama.init_llama(6, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
                              vocab=300, max_len=64, device=dev)
    tokens = torch.randint(0, 300, (2, 33), generator=_gen(dev, 15), device=dev)

    def run(**kw):
        registry.reset_counts()
        out = value_and_grad(lambda p, t: llama.llama_lm_loss(
            p, t, n_heads=8, n_kv_heads=2, memory_budget_bytes=None, **kw))(params, tokens)
        torch.cuda.synchronize()
        return out, registry.counts()

    (loss, grads), counts = run()
    for name in ("norm_vec", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "ce_bwd"):
        assert counts[name]["launches"] > 0 and counts[name]["plain_calls"] == 0, name
    for name in ("flash_attention_bwd_dq_mma", "flash_attention_bwd_dkv_mma"):
        assert counts[name] == {"launches": 0, "plain_calls": 0}, name
    assert _route_launches(counts, "gemm") > 0
    (ploss, pgrads), _ = run(plain=True)
    assert abs(loss.item() - ploss.item()) <= 1e-5 * abs(ploss.item())
    for a, b in zip(tree_leaves(grads), tree_leaves(pgrads)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    (rloss, rgrads), rcounts = run(remat=True)
    assert rloss.item() == loss.item()
    for a, b in zip(tree_leaves(rgrads), tree_leaves(grads)):
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()
    assert rcounts["flash_attention"]["launches"] == counts["flash_attention"]["launches"] + 2
    assert rcounts["norm_vec"]["launches"] == counts["norm_vec"]["launches"] + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("hd,ps", [(64, 16), (128, 64), (256, 16)])
def test_paged_attention(dev, dtype, Hq, Hkv, hd, ps):
    from laser_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_reference)

    g = _gen(dev, 6)
    S, mp = 5, 6
    P = S * mp + 1
    q = _rnd(g, (S, Hq, hd), dtype, dev)
    kp, vp = _rnd(g, (P, Hkv, ps, hd), dtype, dev), _rnd(g, (P, Hkv, ps, hd), dtype, dev)
    tables = torch.randperm(P, generator=g, device=dev)[:S * mp].reshape(S, mp).int()
    lengths = torch.tensor([0, 1, ps - 1, 3 * ps + 5, mp * ps], device=dev, dtype=torch.int32)
    got = paged_attention(q, kp, vp, tables, lengths)
    _check(got, paged_attention_reference(q, kp, vp, tables, lengths), dtype)
    assert (got[0] == 0).all()


def test_paged_attention_rejects_non_contiguous_pool(dev):
    from laser_tpu_torch.ops.paged_attention import paged_attention

    kp = torch.zeros(4, 2, 16, 64, device=dev).transpose(2, 3).contiguous().transpose(2, 3)
    q = torch.zeros(2, 2, 64, device=dev)
    tables = torch.zeros(2, 2, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_attention(q, kp, kp, tables, torch.ones(2, device=dev, dtype=torch.int32))


def test_engine_matches_plain_greedy_with_preemption(dev):
    """The engine on the card (every op a kernel) emits the plain path's
    greedy tokens, through slot reuse and preemption."""
    import numpy as np

    from laser_tpu_torch import registry
    from laser_tpu_torch.models.transformer import greedy_decode, init_transformer
    from laser_tpu_torch.serving import ServingConfig, ServingEngine

    params = init_transformer(3, n_layers=2, d_model=128, n_heads=2, d_ff=256, vocab=97,
                              device=dev)
    cfg = ServingConfig(page_size=16, n_pages=4, max_seqs=2, max_pages_per_seq=3,
                        prefill_buckets=(16, 32))
    eng = ServingEngine(params, n_heads=2, cfg=cfg)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 97, n).astype(np.int32) for n in (14, 15, 9)]
    registry.reset_counts()
    ids = [eng.add_request(p, 12) for p in prompts]
    out = eng.run()
    counts = registry.counts()
    assert all(counts[n]["plain_calls"] == 0 and counts[n]["launches"] > 0
               for n in ("norm_vec", "flash_attention", "paged_attention"))
    assert _route_launches(counts, "gemm") > 0
    assert eng.stats.get("preemptions", 0) >= 1
    for p, rid in zip(prompts, ids):
        want = greedy_decode(params, torch.as_tensor(p[None], device=dev).long(), n_heads=2,
                             max_new_tokens=12, plain=True)[0, len(p):].tolist()
        assert out[rid] == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 8, 17, 300])
@pytest.mark.parametrize("K", [64, 192, 4096])
@pytest.mark.parametrize("group", [16, 64])
def test_w4_gemm(dev, dtype, M, K, group):
    from laser_tpu_torch.ops.gemm.int4_kernel import (ROUTE_KERNELS, gemm_w4, gemm_w4_plain,
                                                      quantize_int4)

    g = _gen(dev, 12)
    N = 200  # not a multiple of the 64-column tile
    h = _rnd(g, (M, K), dtype, dev)
    wq = quantize_int4(_rnd(g, (K, N), torch.float32, dev, std=K ** -0.5), group=group)
    before = sum(k.launches for k in ROUTE_KERNELS.values())
    _check(gemm_w4(h, wq), gemm_w4_plain(h, wq), dtype)
    assert sum(k.launches for k in ROUTE_KERNELS.values()) == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_w4_gemm_scalar_loads(dev, dtype):
    """N % 4 != 0 and an activation 2 bytes off a 16-byte boundary take the
    element-wise loaders."""
    from laser_tpu_torch.ops.gemm.int4_kernel import gemm_w4, gemm_w4_plain, quantize_int4

    g = _gen(dev, 13)
    M, K, N = 19, 96, 99
    h = _rnd(g, (M * K + 1,), dtype, dev)[1:].view(M, K)
    assert h.data_ptr() % 16
    wq = quantize_int4(_rnd(g, (K, N), torch.float32, dev, std=K ** -0.5), group=32)
    _check(gemm_w4(h, wq), gemm_w4_plain(h, wq), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hkv", [8, 4, 2, 1])
@pytest.mark.parametrize("S", [1, 45, 131])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa(dev, dtype, Hkv, S, causal):
    from laser_tpu_torch.ops.attention import (FLASH, FLASH_MMA, attention_gqa,
                                               attention_gqa_reference)

    g = _gen(dev, 14)
    q = _rnd(g, (2, 8, S, 128), dtype, dev)
    k, v = _rnd(g, (2, Hkv, S, 128), dtype, dev), _rnd(g, (2, Hkv, S, 128), dtype, dev)
    before = FLASH.launches + FLASH_MMA.launches
    _check(attention_gqa(q, k, v, causal=causal),
           attention_gqa_reference(q, k, v, causal=causal), dtype)
    assert FLASH.launches + FLASH_MMA.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("hd,ps", [(64, 16), (128, 64)])
def test_paged_attention_int8(dev, dtype, Hq, Hkv, hd, ps):
    from laser_tpu_torch.ops.paged_attention import (ROUTE_KERNELS, paged_attention,
                                                     paged_attention_reference, quantize_kv)

    g = _gen(dev, 15)
    S, mp = 5, 6
    P = S * mp + 1
    q = _rnd(g, (S, Hq, hd), dtype, dev)
    kp, ks = quantize_kv(_rnd(g, (P, Hkv, ps, hd), dtype, dev))
    vp, vs = quantize_kv(_rnd(g, (P, Hkv, ps, hd), dtype, dev))
    tables = torch.randperm(P, generator=g, device=dev)[:S * mp].reshape(S, mp).int()
    lengths = torch.tensor([0, 1, ps, 3 * ps + 5, mp * ps], device=dev, dtype=torch.int32)
    counter = ROUTE_KERNELS[1 if dtype == torch.float32 else 2]  # f32: classic; 16-bit: split
    before = counter.launches
    got = paged_attention(q, kp, vp, tables, lengths, k_scale=ks, v_scale=vs)
    assert counter.launches == before + 1
    _check(got, paged_attention_reference(q, kp, vp, tables, lengths, k_scale=ks, v_scale=vs),
           dtype)
    assert (got[0] == 0).all()


def test_llama_engine_int4_int8_kv_matches_plain(dev):
    """The llama engine on the card with int4 weights and int8 KV pages:
    every kernel of the path launches, no plain version runs, and in f32 the
    first tokens equal the plain llama_generate's on the dequantized
    weights."""
    import numpy as np

    from laser_tpu_torch import registry
    from laser_tpu_torch.models.llama import init_llama, llama_generate
    from laser_tpu_torch.ops.gemm.int4_kernel import dequantize_int4
    from laser_tpu_torch.serving import ServingConfig, ServingEngine

    params = init_llama(5, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
                        vocab=97, max_len=256, device=dev)
    cfg = ServingConfig(page_size=16, n_pages=32, max_seqs=2, max_pages_per_seq=6,
                        prefill_buckets=(16, 32, 64), weight_quant="int4",
                        weight_quant_group=16, kv_quant=True)
    eng = ServingEngine(params, n_heads=8, model="llama", cfg=cfg)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 97, n).astype(np.int32) for n in (7, 21, 40)]
    registry.reset_counts()
    ids = [eng.add_request(p, 6) for p in prompts]
    out = eng.run()
    counts = registry.counts()
    for n in ("w4_gemm", "norm_vec", "flash_attention", "paged_attention"):
        assert counts[n]["launches"] > 0, n
    assert all(c["plain_calls"] == 0 for c in counts.values())
    deq = dict(params, blocks=[{k: dequantize_int4(w) if isinstance(w, dict) else w
                                for k, w in blk.items()} for blk in eng.params["blocks"]])
    for p, rid in zip(prompts, ids):
        want = llama_generate(deq, torch.as_tensor(p[None], device=dev), n_heads=8,
                              n_kv_heads=2, max_new_tokens=6, plain=True)[0, len(p):].tolist()
        assert out[rid][0] == want[0] and len(out[rid]) == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("W", [1, 5, 8])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (32, 8), (8, 1)])
@pytest.mark.parametrize("hd,ps,quant", [(64, 16, False), (128, 64, False), (128, 64, True),
                                         (256, 16, False), (32, 16, True)])
def test_paged_window_attention(dev, dtype, W, Hq, Hkv, hd, ps, quant):
    from laser_tpu_torch.ops.paged_attention import (WINDOW_ROUTE_KERNELS,
                                                     paged_window_attention,
                                                     paged_window_attention_reference,
                                                     quantize_kv)

    g = _gen(dev, 16)
    S, mp = 6, 6
    P = S * mp + 1
    q = _rnd(g, (S, W, Hq, hd), dtype, dev)
    kp, vp = _rnd(g, (P, Hkv, ps, hd), dtype, dev), _rnd(g, (P, Hkv, ps, hd), dtype, dev)
    kw = {}
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        kw = dict(k_scale=ks, v_scale=vs)
    tables = torch.randperm(P, generator=g, device=dev)[:S * mp].reshape(S, mp).int()
    # inactive, exactly W keys, a window across a page, mid-table, full, and
    # a window two positions past the table (rows there see every key it holds)
    lengths = torch.tensor([0, W, ps + W // 2 + 1, 3 * ps + 5, mp * ps, mp * ps + 2],
                           device=dev, dtype=torch.int32)
    # the split route takes 16-bit q at hd 64 and 128, classic the rest
    counter = WINDOW_ROUTE_KERNELS[2 if dtype != torch.float32 and hd in (64, 128) else 1]
    before = counter.launches
    got = paged_window_attention(q, kp, vp, tables, lengths, **kw)
    assert counter.launches == before + 1
    _check_rows(got, paged_window_attention_reference(q, kp, vp, tables, lengths, **kw), dtype)
    assert (got[0] == 0).all()


def test_paged_window_attention_rejects_non_contiguous_q(dev):
    from laser_tpu_torch.ops.paged_attention import paged_window_attention

    q = torch.zeros(2, 4, 3, 64, device=dev).transpose(1, 2)  # (2, 3, 4, 64), strided
    kp = torch.zeros(4, 4, 16, 64, device=dev)
    tables = torch.zeros(2, 2, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_window_attention(q, kp, kp, tables, torch.full((2,), 3, device=dev,
                                                             dtype=torch.int32))


@pytest.mark.parametrize("fill", ["mixed", "at_capacity"])
@pytest.mark.parametrize("model", ["transformer", "llama"])
def test_speculative_engine_matches_plain_engine(dev, model, fill):
    """Bursts, pipelining and speculation on the card: an f32 self-draft
    (int4 for llama, with int8 pages) and a burst engine give the tokens of
    the single-step engine, through the window kernel with no plain call.
    ``at_capacity``: prompt + max_new fills each slot's 6 pages, so the last
    verify windows reach past the table (lengths above max_pages *
    page_size) and the emitted rows must still see every key up to their
    own position."""
    import numpy as np

    from laser_tpu_torch import registry
    from laser_tpu_torch.models.llama import init_llama
    from laser_tpu_torch.models.transformer import init_transformer
    from laser_tpu_torch.serving import ServingConfig, ServingEngine

    if model == "llama":
        params = init_llama(6, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
                            vocab=97, max_len=256, device=dev)
        extra = dict(kv_quant=True)
        dq = "int4"
    else:
        params = init_transformer(7, n_layers=2, d_model=128, n_heads=2, d_ff=256, vocab=97,
                                  device=dev)
        extra, dq = {}, False
    n_heads = 8 if model == "llama" else 2
    rng = np.random.RandomState(9)
    lens, new = ((7, 21, 40, 13), 17) if fill == "mixed" else ((64, 64, 64), 6 * 16 - 64)
    prompts = [rng.randint(0, 97, n).astype(np.int32) for n in lens]

    def run(**kw):
        cfg = ServingConfig(page_size=16, n_pages=40, max_seqs=3, max_pages_per_seq=6,
                            prefill_buckets=(16, 32, 64), **extra, **kw)
        eng = ServingEngine(params, n_heads=n_heads, model=model, cfg=cfg,
                            draft_params=params if kw.get("spec_gamma") else None)
        ids = [eng.add_request(p, new) for p in prompts]
        out = eng.run()
        return [out[i] for i in ids], eng.stats

    base, _ = run()
    burst, _ = run(decode_burst=8, pipeline_bursts=True)
    registry.reset_counts()
    spec, stats = run(decode_burst=10, spec_gamma=4, pipeline_bursts=True,
                      draft_weight_quant=dq)
    counts = registry.counts()
    assert counts["paged_window_attention"]["launches"] > 0
    assert all(c["plain_calls"] == 0 for c in counts.values())
    assert all(len(o) == new for o in base)
    assert base == burst == spec and stats["spec_live_rounds"] > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("xs,ws,pad", [
    ((2, 3, 17, 35), (5, 3, 3, 3), (1, 1)),
    ((1, 1, 9, 40), (40, 1, 5, 5), (2, 2)),    # two blocks of 32 output channels
    ((3, 64, 6, 7), (7, 64, 1, 1), (1, 0)),    # 64 taps, > 48 KB of shared memory
    ((2, 2, 5, 3), (3, 2, 4, 2), (0, 1))])     # a kernel wider than its image
def test_conv_planewise(dev, dtype, xs, ws, pad):
    from laser_tpu_torch.ops.conv import (CONV_PLANEWISE, conv2d_planewise_reference,
                                          conv_planewise)

    g = _gen(dev, 30)
    x, w = _rnd(g, xs, dtype, dev), _rnd(g, ws, torch.float32, dev)
    before = CONV_PLANEWISE.launches
    _check(conv_planewise(x, w, pad), conv2d_planewise_reference(x, w, pad), dtype)
    assert CONV_PLANEWISE.launches == before + 1


# the direct conv's route by dtype (csrc/conv.cu pick_route)
CONV_ROUTE = {torch.float32: "conv_direct_ffma", torch.bfloat16: "conv_direct_mma",
              torch.float16: "conv_direct_mma"}


def _conv_inputs(seed, xs, ws, dtype, dev):
    g = _gen(dev, seed)
    return _rnd(g, xs, dtype, dev), _rnd(g, ws, dtype, dev,
                                         std=(ws[1] * ws[2] * ws[3]) ** -0.5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", [None, "classic"])
@pytest.mark.parametrize("xs,ws,pad", [
    ((2, 8, 13, 17), (6, 8, 3, 3), (1, 1)),
    ((1, 20, 30, 30), (70, 20, 3, 3), (1, 1)),   # two tiles of 64 output channels
    ((2, 16, 9, 11), (5, 16, 5, 3), (2, 1)),
    ((1, 65, 7, 7), (3, 65, 1, 1), (0, 0))])     # K = 65: a ragged last slab
def test_conv_direct(dev, dtype, route, xs, ws, pad):
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.conv import conv2d_direct_reference, conv_direct

    x, w = _conv_inputs(31, xs, ws, dtype, dev)
    registry.reset_counts()
    got = conv_direct(x, w, pad, route=route)
    c = registry.counts()
    name = "conv_direct" if route == "classic" else CONV_ROUTE[dtype]
    assert c[name]["launches"] == 1 == sum(v["launches"] for v in c.values())
    _check(got, conv2d_direct_reference(x, w, pad), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("xs,ws,pad,strides", [
    ((2, 8, 20, 20), (16, 8, 3, 3), (1, 1), (2, 2)),
    ((1, 20, 17, 19), (6, 20, 5, 5), (2, 2), (3, 2))])
def test_conv2d_direct_strided(dev, dtype, xs, ws, pad, strides):
    """A strided conv is one launch of the direct kernel at the stride (no
    phase convs, pad, copies or adds), against its plain version there."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.conv import conv2d_direct, conv2d_direct_reference

    x, w = _conv_inputs(32, xs, ws, dtype, dev)
    registry.reset_counts()
    got = conv2d_direct(x, w, pad, strides)
    c = registry.counts()
    assert c[CONV_ROUTE[dtype]]["launches"] == 1 == sum(v["launches"] for v in c.values())
    assert all(v["plain_calls"] == 0 for v in c.values())
    _check(got, conv2d_direct_reference(x, w, pad, strides), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("xs,ws,pad,strides", [
    ((2, 8, 13, 17), (6, 8, 3, 3), (1, 1), (1, 1)),
    ((1, 20, 30, 30), (70, 20, 3, 3), (1, 1), (1, 1)),     # K 180, two channel tiles
    ((2, 16, 9, 11), (5, 16, 5, 3), (2, 1), (1, 1)),       # a 5 x 3 kernel
    ((1, 65, 7, 7), (3, 65, 1, 1), (0, 0), (1, 1)),        # K 65
    ((2, 64, 56, 56), (64, 64, 3, 3), (1, 1), (2, 2)),     # C1's conv 3 at stride 2
    ((1, 20, 17, 19), (70, 20, 5, 5), (2, 2), (3, 2)),
    ((2, 65, 20, 23), (7, 65, 1, 1), (0, 0), (2, 2)),      # a strided 1x1, K 65
    ((1, 4, 300, 37), (9, 4, 3, 5), (0, 2), (1, 3)),       # many pixel tiles
    ((1, 130, 9, 9), (16, 130, 3, 3), (1, 1), (1, 1))])    # K 1170: two tap-table chunks
def test_conv_direct_gather_routes(dev, dtype, xs, ws, pad, strides):
    """The ffma (f32) and mma (bf16/f16) routes, each launched once and
    nothing else, against the plain version at the stride."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.conv import conv2d_direct_reference, conv_direct

    x, w = _conv_inputs(38, xs, ws, dtype, dev)
    registry.reset_counts()
    got = conv_direct(x, w, pad, strides)
    c = registry.counts()
    assert c[CONV_ROUTE[dtype]]["launches"] == 1 == sum(v["launches"] for v in c.values())
    _check(got, conv2d_direct_reference(x, w, pad, strides), dtype)


def test_conv_direct_routes_asked_for(dev):
    """Each route runs where asked and raises where it does not fit: ffma
    takes f32 only, mma bf16/f16 only, classic stride 1 only; an unknown
    name raises."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.conv import conv2d_direct_reference, conv_direct

    for dtype, route, other in ((torch.float32, "ffma", "mma"),
                                (torch.bfloat16, "mma", "ffma"),
                                (torch.float16, "mma", "ffma")):
        x, w = _conv_inputs(39, (2, 16, 12, 12), (8, 16, 3, 3), dtype, dev)
        registry.reset_counts()
        _check(conv_direct(x, w, (1, 1), (2, 2), route=route),
               conv2d_direct_reference(x, w, (1, 1), (2, 2)), dtype)
        assert registry.counts()[CONV_ROUTE[dtype]]["launches"] == 1
        with pytest.raises(ValueError, match=other):
            conv_direct(x, w, (1, 1), route=other)
        with pytest.raises(ValueError, match="classic"):
            conv_direct(x, w, (1, 1), (2, 2), route="classic")
        with pytest.raises(ValueError, match="unknown route"):
            conv_direct(x, w, (1, 1), route="wgmma")


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv2d_direct_classic_strided_runs_the_phases(dev, dtype):
    """route="classic" at a stride keeps laser_tpu's phase decomposition on
    the classic kernels: at 3 x 3 stride 2, three phase convs on the classic
    direct kernel and the 1 x 1 phase through ``gemm`` (a plain float
    product: torch.matmul, as laser_tpu hands it to XLA)."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.conv import conv2d_direct, conv2d_direct_reference

    x, w = _conv_inputs(40, (2, 64, 20, 21), (16, 64, 3, 3), dtype, dev)
    registry.reset_counts()
    got = conv2d_direct(x, w, (1, 1), (2, 2), route="classic")
    c = registry.counts()
    assert c["conv_direct"]["launches"] == 3 == sum(v["launches"] for v in c.values())
    assert all(v["plain_calls"] == 0 for v in c.values())
    want = conv2d_direct_reference(x, w, (1, 1), (2, 2))
    if dtype == torch.float32:
        _check(got, want, dtype)
    else:
        # laser_tpu's phases round each phase conv to the dtype and add the
        # phases in it (4 phase roundings, 3 of the adds): within 8 unit
        # roundings of max of the kernel route's one rounding (ROADMAP.md
        # queue 3, settled on purpose)
        torch.cuda.synchronize()
        u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -11
        err = (got.float() - want.float()).abs().max() / want.float().abs().max()
        assert err.item() <= 8 * u, err.item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (3, 33), (16, 1000), (5, 4096), (2, 16384)])
def test_softmax_rows(dev, dtype, shape):
    from laser_tpu_torch.ops.vector_math import SOFTMAX_VEC, softmax, softmax_reference

    g = _gen(dev, 33)
    x = _rnd(g, shape, dtype, dev, std=4.0)
    before = SOFTMAX_VEC.launches
    _check_rows(softmax(x), softmax_reference(x), dtype)
    assert SOFTMAX_VEC.launches == before + 1


def _softmax_rows_input(g, dev, dtype, rows, cols, offset):
    """(rows, cols) rows, contiguous at an element ``offset`` into a buffer:
    offset 0 puts every row of whole vectors on a 16-byte boundary, offset 1
    none; a ragged width puts its rows at every offset."""
    buf = _rnd(g, (rows * cols + offset,), dtype, dev, std=4.0)
    return buf[offset:].view(rows, cols)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cols", [1, 31, 32, 33, 1000, 1024, 1025, 4096, 16384])
@pytest.mark.parametrize("offset", [0, 1])
def test_softmax_vec_against_plain_and_classic(dev, dtype, cols, offset):
    """The vec kernel (the route softmax picks) at every width class on 5
    rows (a warp a row to 64 vectors, four warps to 1024 columns, two rows
    a block, a block past it, 1024 threads for the widest f32 rows), ragged
    widths and unaligned rows (the head and tail elements);
    against the plain version and the classic kernel asked for, each row
    against its own max."""
    from laser_tpu_torch.ops.vector_math import (SOFTMAX, SOFTMAX_VEC, softmax,
                                                 softmax_reference)

    x = _softmax_rows_input(_gen(dev, 38), dev, dtype, 5, cols, offset)
    before, classic = SOFTMAX_VEC.launches, SOFTMAX.launches
    got = softmax(x)
    assert SOFTMAX_VEC.launches == before + 1
    _check_rows(got, softmax_reference(x), dtype)
    _check_rows(got, softmax(x, route="classic"), dtype)
    assert SOFTMAX.launches == classic + 1
    assert torch.equal(softmax(x, route="vec"), got)  # the same bits on each call


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cols", [100, 1000, 1024])
@pytest.mark.parametrize("offset", [0, 1])
def test_softmax_vec_many_rows(dev, dtype, cols, offset):
    """4099 rows (past the count below which a narrow row takes four warps):
    a warp a row, eight rows a block, the last block part empty."""
    from laser_tpu_torch.ops.vector_math import SOFTMAX_VEC, softmax, softmax_reference

    x = _softmax_rows_input(_gen(dev, 40), dev, dtype, 4099, cols, offset)
    before = SOFTMAX_VEC.launches
    _check_rows(softmax(x), softmax_reference(x), dtype)
    assert SOFTMAX_VEC.launches == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cols", [7, 1000, 4099])
def test_softmax_vec_neg_inf_and_donate(dev, dtype, cols):
    """An all -inf row is NaN (0 / 0), -inf entries give exactly 0, as the
    classic kernel; donated unaligned rows are written in place; y at
    another offset from a 16-byte boundary than x (scalar stores)."""
    from laser_tpu_torch.ops.vector_math import softmax, softmax_reference

    x = _softmax_rows_input(_gen(dev, 39), dev, dtype, 4, cols, 1)
    x[1] = -torch.inf
    x[2, ::3] = -torch.inf
    want = softmax_reference(x)
    got = softmax(x)  # y fresh and aligned, x one element off
    classic = softmax(x, route="classic")
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all() and torch.isnan(classic[1]).all()
    assert (got[2, ::3] == 0).all()
    keep = [0, 2, 3]
    _check_rows(got[keep], want[keep], dtype)
    # donated rows at x's offset: the same split of each row into head,
    # vectors and tail, so the same sums and bits as the call above
    y = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape).copy_(x)
    out = softmax(y, donate=True)
    assert out.data_ptr() == y.data_ptr()
    _check_rows(out[keep], want[keep], dtype)
    assert torch.equal(out[keep], got[keep])


def test_softmax_rows_past_a_launch_raise(dev):
    """The launchers take the row count as a C int: 2^31 rows raise before
    any launch, on the short path and on the reshaped one."""
    from laser_tpu_torch.ops.vector_math import SOFTMAX_MAX_ROWS, SOFTMAX_VEC, softmax

    x = torch.empty(SOFTMAX_MAX_ROWS + 1, 1, dtype=torch.bfloat16, device=dev)
    before = SOFTMAX_VEC.launches
    for call in (lambda: softmax(x, donate=True), lambda: softmax(x.view(2, -1, 1), donate=True)):
        with pytest.raises(ValueError, match="rows"):
            call()
    assert SOFTMAX_VEC.launches == before
    del x
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 1), (4, 1000), (2, 16385), (3, 40001)])
def test_softmax_online(dev, dtype, shape):
    """The online function at any width: the cluster kernel by default, the
    classic online kernel asked for, one launch each."""
    from laser_tpu_torch.ops.vector_math import (SOFTMAX_ONLINE, SOFTMAX_ONLINE_CLUSTER,
                                                 softmax_online, softmax_online_reference)

    g = _gen(dev, 34)
    x = _rnd(g, shape, dtype, dev, std=4.0)
    before, classic = SOFTMAX_ONLINE_CLUSTER.launches, SOFTMAX_ONLINE.launches
    _check_rows(softmax_online(x), softmax_online_reference(x), dtype)
    assert SOFTMAX_ONLINE_CLUSTER.launches == before + 1
    _check_rows(softmax_online(x, route="classic"), softmax_online_reference(x), dtype)
    assert SOFTMAX_ONLINE.launches == classic + 1 and SOFTMAX_ONLINE_CLUSTER.launches == before + 1


# the cluster kernel's bar against the plain version and the classic online
# kernel (the sums are taken in another order): f32 rtol 1e-5, atol 1e-9;
# bf16 and f16 one unit in the last place, 2^-7 relative (bf16's unit; f16's
# is 2^-10), and for f16's subnormals one unit, 2^-24
ONLINE_TOL = {torch.float32: (1e-5, 1e-9), torch.bfloat16: (2.0 ** -7, 0.0),
              torch.float16: (2.0 ** -7, 2.0 ** -24)}


def _check_online(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    rtol, atol = ONLINE_TOL[dtype]
    g, w = got.double(), want.double()
    bad = ((g - w).abs() > rtol * w.abs() + atol).sum().item()
    assert bad == 0, (bad, (g - w).abs().max().item())


def _online_rows(g, dev, dtype, rows, cols, offset):
    """(rows, cols) randn * 4 rows at an element ``offset`` into a buffer,
    row 1 (where there is one) with every third entry -inf."""
    x = _softmax_rows_input(g, dev, dtype, rows, cols, offset)
    if rows > 1:
        x[1, ::3] = -torch.inf
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols", [(5, 1), (5, 17), (5, 16385), (5, 128256), (64, 128256),
                                       (301, 20000), (3, 262144), (3, 262145)])
@pytest.mark.parametrize("offset", [0, 1])
def test_softmax_online_cluster_against_plain_and_classic(dev, dtype, rows, cols, offset):
    """The cluster kernel at widths 1 to 262144 (one block a row to 16 of a
    cluster; 128256: Llama-3's vocabulary), at 64 and 301 rows (more blocks
    than one resident wave), unaligned rows (head and tail elements), -inf
    entries exactly 0; 262145 is one past what a cluster holds on chip,
    which takes the classic online kernel. Against the plain version and the classic
    kernel; softmax() past 16384 columns takes the same kernels by the same
    routes."""
    from laser_tpu_torch.ops.vector_math import (SOFTMAX_CLUSTER_MAX_COLS, SOFTMAX_ONLINE,
                                                 SOFTMAX_ONLINE_CLUSTER, softmax,
                                                 softmax_online, softmax_online_reference)

    x = _online_rows(_gen(dev, 41), dev, dtype, rows, cols, offset)
    fits = cols <= SOFTMAX_CLUSTER_MAX_COLS
    before, classic = SOFTMAX_ONLINE_CLUSTER.launches, SOFTMAX_ONLINE.launches
    got = softmax_online(x)
    assert SOFTMAX_ONLINE_CLUSTER.launches == before + fits
    assert SOFTMAX_ONLINE.launches == classic + (not fits)
    want = softmax_online_reference(x)
    _check_online(got, want, dtype)
    assert (got[1, ::3] == 0).all()
    old = softmax_online(x, route="classic")
    assert SOFTMAX_ONLINE.launches == classic + 1 + (not fits)
    _check_online(got, old, dtype)
    if cols > 16384:
        assert torch.equal(softmax(x), got)
        assert torch.equal(softmax(x, route="classic"), old)
        assert SOFTMAX_ONLINE_CLUSTER.launches == before + 2 * fits


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cols", [17, 20000, 128256, 262144])
def test_softmax_online_cluster_all_neg_inf_and_donate(dev, dtype, cols):
    """An all -inf row gives 0 (its sum taken as 1), as the classic online
    kernel; donated rows are written in place, aligned and one element off,
    with the same bits as a fresh output."""
    from laser_tpu_torch.ops.vector_math import (SOFTMAX_ONLINE_CLUSTER, softmax,
                                                 softmax_online, softmax_online_reference)

    for offset in (0, 1):
        x = _online_rows(_gen(dev, 42), dev, dtype, 4, cols, offset)
        x[2] = -torch.inf
        want = softmax_online_reference(x)
        got = softmax_online(x)
        torch.cuda.synchronize()
        assert (got[2] == 0).all() and (softmax_online(x, route="classic")[2] == 0).all()
        _check_online(got, want, dtype)
        # rows at x's offset: the same split of each row, so the same bits
        y = _softmax_rows_input(_gen(dev, 44), dev, dtype, 4, cols, offset).copy_(x)
        before = SOFTMAX_ONLINE_CLUSTER.launches
        out = softmax(y, donate=True) if cols > 16384 else softmax_online(y)
        if cols > 16384:
            assert out.data_ptr() == y.data_ptr()
        assert SOFTMAX_ONLINE_CLUSTER.launches == before + 1
        assert torch.equal(out, got)


def test_softmax_online_cluster_graph_replay(dev):
    """Captured in a CUDA graph and replayed on new rows: this replay's
    result, one launch a call."""
    from laser_tpu_torch.ops.vector_math import (SOFTMAX_ONLINE_CLUSTER, softmax_online,
                                                 softmax_online_reference)

    g = _gen(dev, 43)
    x = _rnd(g, (64, 128256), torch.bfloat16, dev, std=4.0)
    softmax_online(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        softmax_online(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = SOFTMAX_ONLINE_CLUSTER.launches
    with torch.cuda.graph(graph):
        y = softmax_online(x)
    assert SOFTMAX_ONLINE_CLUSTER.launches == before + 1
    x.copy_(_rnd(g, (64, 128256), torch.bfloat16, dev, std=4.0))
    graph.replay()
    _check_online(y, softmax_online_reference(x), torch.bfloat16)


@pytest.mark.parametrize("cols", [100, 20000])
def test_softmax_all_neg_inf_rows_and_donate(dev, cols):
    """Row 1 is all -inf: NaN from the row kernel, 0 from the online one
    (cols > 16384), as laser_tpu's two kernels; ``donate`` writes in place."""
    from laser_tpu_torch.ops.vector_math import softmax, softmax_online_reference

    g = _gen(dev, 35)
    x = _rnd(g, (3, cols), torch.float32, dev)
    x[1] = -torch.inf
    x[2, ::3] = -torch.inf
    want = softmax_online_reference(x)
    got = softmax(x.clone())
    if cols > 16384:
        assert (got[1] == 0).all()
    else:
        assert torch.isnan(got[1]).all()
    _check_rows(got[0::2], want[0::2], torch.float32)
    y = x.clone()
    out = softmax(y, donate=True)
    assert out.data_ptr() == y.data_ptr()
    _check_rows(out[0::2], want[0::2], torch.float32)


def test_cnn_and_mlp_through_the_kernels(dev):
    """A small CNN and MLP on the card: logits of the kernel route against
    the plain route, every conv, GEMM and softmax launched once per use and
    no plain call."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.models.cnn import cnn_forward, cnn_predict, init_cnn
    from laser_tpu_torch.models.mlp import init_mlp, mlp_predict

    params = init_cnn(3, conv_channels=(8, 12, 10), hidden=32, num_classes=17, image_hw=24,
                      device=dev)
    x = _rnd(_gen(dev, 36), (5, 3, 24, 24), torch.float32, dev)
    with torch.no_grad():
        want = cnn_forward(params, x, plain=True)
        registry.reset_counts()
        probs = cnn_predict(params, x)
        c = registry.counts()
        _check(cnn_forward(params, x), want, torch.float32)
        assert (c["conv_planewise"]["launches"], c["conv_direct_ffma"]["launches"],
                _route_launches(c, "gemm"), c["softmax_vec"]["launches"]) == (1, 2, 2, 1)
        assert all(v["plain_calls"] == 0 for v in c.values())
        assert (probs.sum(-1) - 1).abs().max().item() <= 1e-5
        mp = init_mlp(4, [50, 64, 9], device=dev)
        xm = _rnd(_gen(dev, 37), (7, 50), torch.float32, dev)
        _check(mlp_predict(mp, xm), mlp_predict(mp, xm, plain=True), torch.float32)


# ---------------------------------------------------------------------------
# The elementwise and reduction templates (csrc/foreach.cuh) with generated
# bodies: each result against the plain version on the same card tensors.
# Elementwise f32 bodies of + - * / and the accurate vector-math cores are
# exact (the kernel rounds each op as eager PyTorch does); library
# functions (sinf, expf, ...) may differ from PyTorch's by an ulp or two.
# ---------------------------------------------------------------------------

FE_BODIES = {
    "arith": lambda x, y: (x + y) * x - y / (x.abs() + 1.0),
    "transcendental": lambda x, y: torch.sin(x) + torch.cos(y) * torch.exp(-x.abs()),
    "select": lambda x, y: torch.where(x > y, torch.maximum(x, y) ** 2, -torch.relu(y)),
    "cast": lambda x, y: (x.to(torch.bfloat16) * 3.0).float() + y.clamp(-1.0, 1.0),
}


def _fe_operands(dev, dtype, n, seed, offset=0):
    g = _gen(dev, seed)
    if dtype.is_floating_point:
        base = [_rnd(g, (n + offset,), dtype, dev) for _ in range(2)]
    else:
        base = [torch.randint(-50, 50, (n + offset,), generator=g, device=dev, dtype=dtype)
                for _ in range(2)]
    return [b[offset:] for b in base]


@pytest.mark.parametrize("body", sorted(FE_BODIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,offset", [(1, 0), (1000, 0), (4097 * 3, 0), (1000, 1),
                                      (4096 * 37 + 5, 3)])
def test_for_each_bodies(dev, body, dtype, n, offset):
    """n 1 to 151557; offset > 0: every operand starts 1-3 elements into its
    buffer, so the pointers are not 16-byte aligned (the scalar path)."""
    from laser_tpu_torch.ops.foreach import FOR_EACH, for_each, for_each_reference

    x, y = _fe_operands(dev, dtype, n, 40 + n % 7, offset)
    fn = FE_BODIES[body]
    want = for_each_reference(fn, x, y)
    before = FOR_EACH.launches
    got = for_each(fn, x, y)
    assert FOR_EACH.launches == before + 1
    _check(got, want, dtype, floor=1.0)
    if body == "arith" and dtype == torch.float32:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.int64])
def test_for_each_integer_and_bool(dev, dtype):
    from laser_tpu_torch.ops.foreach import for_each, for_each_reference

    x, y = _fe_operands(dev, dtype, 5003, 41)
    for fn in (lambda a, b: a * 3 - b, lambda a, b: torch.maximum(a, b).abs(),
               lambda a, b: (a > b) | (b == 0), lambda a, b: a / (b.abs() + 1)):
        assert torch.equal(for_each(fn, x, y), for_each_reference(fn, x, y))


def test_for_each_donate_and_multi(dev):
    from laser_tpu_torch.ops.foreach import (for_each, for_each_multi,
                                             for_each_multi_reference, for_each_reference)

    x, y = _fe_operands(dev, torch.float32, 70001, 42)
    want = for_each_reference(lambda a, b: a * 2 + b, x, y)
    xd = x.clone()
    out = for_each(lambda a, b: a * 2 + b, xd, y, donate=True)
    assert out.data_ptr() == xd.data_ptr() and torch.equal(xd, want)
    fn = lambda a, b: (a + b, (a - b).to(torch.bfloat16), a > b)  # noqa: E731
    got, ref = for_each_multi(fn, x, y), for_each_multi_reference(fn, x, y)
    assert all(torch.equal(g, r) for g, r in zip(got, ref, strict=True))


def test_body_reads_its_closure_on_every_call(dev):
    """A body whose closure scalar changes between calls gives this call's
    value on the card, as the plain version does (the body is traced on
    every call)."""
    from laser_tpu_torch.ops.foreach import for_each, map_reduce, row_reduce

    x, _ = _fe_operands(dev, torch.float32, 4099, 44)
    scale = 2.0
    body = lambda a: a * scale  # noqa: E731
    assert torch.equal(for_each(body, x), x * 2.0)
    scale = 3.0
    assert torch.equal(for_each(body, x), x * 3.0)
    ones = torch.ones(8, 64, device=dev)
    assert torch.equal(row_reduce(body, ones), torch.full((8,), 192.0, device=dev))
    scale = -1.0
    assert map_reduce(body, ones).item() == -512.0


@pytest.mark.parametrize("name", ["exp", "log", "tanh", "sigmoid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_math_tiers(dev, name, dtype):
    """The accurate tier equals its plain version (laser_tpu's polynomial in
    torch) bit for bit; the fast tier (CUDA intrinsics) is within 2e-5 of
    torch's function in f32 (__expf: 105 ulp at 88) and one bf16 rounding."""
    from laser_tpu_torch.ops import vector_math as vm
    from laser_tpu_torch.ops.foreach import for_each_reference

    g = _gen(dev, 43)
    x = torch.cat([_rnd(g, (100003,), torch.float32, dev, std=30.0),
                   torch.tensor([0.0, -0.0, 88.0, -88.0, 87.5, -87.5, torch.inf, -torch.inf,
                                 torch.nan, 1e-30, -1e-30], device=dev)]).to(dtype)
    if name == "log":
        x = x.abs()
    acc = getattr(vm, name)(x, algorithm="accurate")
    want = for_each_reference(vm.pick(name, "accurate"), x)
    assert torch.equal(torch.nan_to_num(acc.float(), nan=7.0),
                       torch.nan_to_num(want.float(), nan=7.0))
    fast = getattr(vm, name)(x, algorithm="fast")
    ref = {"exp": torch.exp, "log": torch.log, "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    r = ref[name](x.float())
    ok = torch.isfinite(r) & (r.abs() < 1e37)
    err = ((fast.float() - r).abs() / r.abs().clamp(min=1.0))[ok].max().item()
    assert err <= (2e-5 if dtype == torch.float32 else 2 ** -8), err


def _reduce_inputs(dev, dtype, n, seed):
    g = _gen(dev, seed)
    if dtype.is_floating_point:
        return _rnd(g, (n,), dtype, dev)
    return torch.randint(-1000, 1000, (n,), generator=g, device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("n", [1, 2, 1000, 65536 * 3 + 17])
def test_reductions_deterministic(dev, dtype, n):
    """Sums within 1e-6 of sum |x| of the plain version (order only), min
    and max exact, the same bits twice."""
    from laser_tpu_torch.ops import reductions as R

    x = _reduce_inputs(dev, dtype, n, 44)
    s1, s2 = R.reduce_sum(x), R.reduce_sum(x)
    assert torch.equal(s1, s2) and s1.dtype == dtype
    want = x.double().sum().item()
    if dtype.is_floating_point:
        tol = 1e-6 * x.double().abs().sum().item() + (0 if dtype == torch.float32 else
                                                      abs(want) * 2 ** -8)
        assert abs(s1.item() - want) <= tol
    else:
        assert s1.item() == int(x.long().sum().item())
    assert R.reduce_min(x).item() == x.min().item()
    assert R.reduce_max(x).item() == x.max().item()
    f32 = R.reduce_sum(x, acc_dtype=torch.float32)
    assert abs(f32.item() - want) <= 1e-6 * x.double().abs().sum().item() + 1e-6


def test_reduce_sum_quarter_of_int_range(dev):
    """n = 2^29 + 3 f32 elements (2 GB): 64-bit indexing, within 1e-6 of
    sum |x|, the same bits twice."""
    from laser_tpu_torch.ops.reductions import reduce_sum

    x = torch.rand((2 ** 29 + 3,), generator=_gen(dev, 45), device=dev)
    a, b = reduce_sum(x), reduce_sum(x)
    assert torch.equal(a, b)
    assert abs(a.item() - x.double().sum().item()) <= 1e-6 * x.double().sum().item()


@pytest.mark.parametrize("reduce_fn", [torch.sum, torch.amin, torch.amax])
@pytest.mark.parametrize("shape", [(1, 1), (7, 333), (64, 4096), (3, 100003)])
def test_row_reduce(dev, reduce_fn, shape):
    from laser_tpu_torch.ops.foreach import ROW_REDUCE, row_reduce, row_reduce_reference

    g = _gen(dev, 46)
    x, y = _rnd(g, shape, torch.float32, dev), _rnd(g, shape, torch.float32, dev)
    fn = lambda a, b: torch.exp(a * 0.5) - b  # noqa: E731
    ident = {torch.sum: 0.0, torch.amin: float("inf"), torch.amax: -float("inf")}[reduce_fn]
    before = ROW_REDUCE.launches
    got = row_reduce(fn, x, y, reduce_fn=reduce_fn, identity=ident)
    assert ROW_REDUCE.launches == before + 1
    want = row_reduce_reference(fn, x, y, reduce_fn=reduce_fn, identity=ident)
    assert torch.equal(got, row_reduce(fn, x, y, reduce_fn=reduce_fn, identity=ident))
    if reduce_fn is torch.sum:
        bound = fn(x, y).abs().sum(-1) * 1e-6 + 1e-6
        assert ((got - want).abs() <= bound).all(), (got - want).abs().max()
    else:
        # the maps are the same expf on both sides, up to an ulp
        assert ((got - want).abs() <= 1e-6 * want.abs() + 1e-6).all()


def test_map_reduce_custom_combine_and_padding(dev):
    """A combine_fn outside the vocabulary gets the per-block partials;
    exp summed over 1000 values maps no padding."""
    from laser_tpu_torch.ops.foreach import MAP_REDUCE, map_reduce, map_reduce_reference

    x = _rnd(_gen(dev, 47), (300001,), torch.float32, dev)
    before = MAP_REDUCE.launches
    got = map_reduce(lambda a: a * a, x, combine_fn=lambda p: p.sum() / p.numel())
    want = map_reduce_reference(lambda a: a * a, x, combine_fn=lambda p: p.sum() / p.numel())
    assert MAP_REDUCE.launches == before + 1
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())
    small = x[:1000]
    e = map_reduce(torch.exp, small)
    assert abs(e.item() - small.double().exp().sum().item()) <= 1e-5 * e.item()


def test_lux_on_the_kernels(dev):
    from laser_tpu_torch import lux, registry

    g = _gen(dev, 48)
    a, b, c = (_rnd(g, (33, 70), torch.float32, dev) for _ in range(3))
    w = _rnd(g, (70, 24), torch.float32, dev)
    bias = _rnd(g, (24,), torch.float32, dev)
    registry.reset_counts()
    f = lux.generate(lambda p, q, r: p + q - lux.lux_sin(r))
    _check(f(a, b, c), a + b - torch.sin(c), torch.float32)
    rr = lux.generate(lambda p, q: lux.lux_sum(p * q, axis=-1))
    _check(rr(a, b), (a * b).sum(-1), torch.float32)
    mr = lux.generate(lambda p: lux.lux_max(lux.lux_exp(p)))
    _check(mr(a), torch.exp(a).max(), torch.float32)
    gm = lux.generate(lambda p, q, r: lux.lux_relu(p @ q + r))
    _check(gm(a, w, bias), torch.relu(a @ w + bias), torch.float32)
    c_ = registry.counts()
    assert [c_[k]["launches"] for k in ("for_each", "row_reduce", "map_reduce")] + \
        [_route_launches(c_, "gemm")] == [1, 1, 1, 1]
    assert all(v["plain_calls"] == 0 for v in c_.values())


# ---------------------------------------------------------------------------
# the layout and strided primitives: csrc/transpose.cu, the strided and
# staged templates of csrc/foreach.cuh
# ---------------------------------------------------------------------------

# one dtype of each element size the transpose kernels move, and beside them
ELEM_DTYPES = [torch.uint8, torch.int8, torch.bfloat16, torch.float16, torch.float32,
               torch.int32, torch.float64, torch.int64]


def _any(g, shape, dtype, dev):
    if dtype.is_floating_point:
        return _rnd(g, shape, dtype, dev)
    return torch.randint(-100 if dtype != torch.uint8 else 0, 100, shape, generator=g,
                         device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", ELEM_DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (100, 37), (7, 300), (33, 65), (3, 100, 50),
                                   (2, 1, 129)])
def test_transpose_out_of_place(dev, dtype, shape):
    """Ragged tiles on both axes, batched and not: the same bits as torch."""
    from laser_tpu_torch.ops.transpose import TRANSPOSE, transpose2d, transpose2d_batched

    x = _any(_gen(dev, 60), shape, dtype, dev)
    before = TRANSPOSE.launches
    got = transpose2d(x) if x.dim() == 2 else transpose2d_batched(x)
    assert TRANSPOSE.launches == before + 1
    assert torch.equal(got, x.transpose(-1, -2).contiguous())


# every dtype at N 128 and 384, and each element size once at 8192
IN_PLACE_CASES = [(dt, n) for n in (128, 384) for dt in ELEM_DTYPES] + [
    (dt, 8192) for dt in (torch.uint8, torch.bfloat16, torch.float32, torch.int64)]


@pytest.mark.parametrize("dtype,n", IN_PLACE_CASES)
def test_transpose_in_place(dev, dtype, n):
    from laser_tpu_torch.ops.transpose import TRANSPOSE_INPLACE, transpose2d

    x = _any(_gen(dev, 61), (n, n), dtype, dev)
    want = x.t().contiguous()
    before = TRANSPOSE_INPLACE.launches
    got = transpose2d(x, donate=True)
    assert TRANSPOSE_INPLACE.launches == before + 1
    assert got.data_ptr() == x.data_ptr() and torch.equal(x, want)


@pytest.mark.parametrize("n", [1, 31, 100, 130])
def test_transpose_in_place_kernel_ragged(dev, n):
    """The in-place kernel masks a ragged edge, though transpose2d routes
    such N out of place."""
    from laser_tpu_torch.ops.transpose import _transpose_inplace_cuda, transpose2d

    x = _any(_gen(dev, 62), (n, n), torch.float32, dev)
    want = x.t().contiguous()
    _transpose_inplace_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(x, want)
    y = _any(_gen(dev, 63), (n, n), torch.float32, dev)
    assert transpose2d(y, donate=True).data_ptr() != y.data_ptr()


def test_nchw_nhwc_round_trip(dev):
    from laser_tpu_torch.ops.transpose import nchw2nhwc, nhwc2nchw

    x = _rnd(_gen(dev, 64), (3, 19, 7, 11), torch.float32, dev)
    y = nchw2nhwc(x)
    assert torch.equal(y, x.permute(0, 2, 3, 1).contiguous())
    assert torch.equal(nhwc2nchw(y), x)


def _strided_cases(dev, dtype):
    """(name, operand, its plain value) over one (24, 40, 36) buffer."""
    from laser_tpu_torch.tensor import TensorView

    g = _gen(dev, 65)
    base = _any(g, (24, 40, 36), dtype, dev)
    flat = base.reshape(-1)
    return [
        ("every2row_offset", TensorView(flat, (12, 40, 36), (2 * 1440, 36, 1), 1440),
         base[1::2]),
        ("torch_every2row", base[1::2], base[1::2]),
        ("every3col", base[:, :, 1::3], base[:, :, 1::3]),
        ("neg_rows", TensorView(flat, (24, 40, 36), (-1440, 36, 1), 23 * 1440), base.flip(0)),
        ("neg_cols", TensorView(flat, (24, 40, 36), (1440, 36, -1), 35), base.flip(2)),
        ("neg_mid_skip", TensorView(flat, (24, 20, 36), (1440, -72, 1), 39 * 36),
         base.flip(1)[:, ::2]),
        ("strided_1d", flat[5::7], flat[5::7]),
        ("transposed", base.transpose(0, 2), base.transpose(0, 2)),
        ("broadcast", TensorView(flat, (24, 40, 36), (0, 36, 1), 0),
         base[0:1].expand(24, 40, 36)),
        ("window", base[3:9, 2:30, 4:32], base[3:9, 2:30, 4:32]),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8,
                                   torch.int64])
def test_for_each_over_strided_views(dev, dtype):
    """Offsets, every k-th row or column, negative strides on each axis, 1-D
    strided, transposed and broadcast views, alone and beside a contiguous
    operand: the same bits as the plain version."""
    from laser_tpu_torch.ops.foreach import for_each
    from laser_tpu_torch.ops.strided import (FOR_EACH_STRIDED, FOR_EACH_STRIDED_TILED,
                                             strided_for_each, strided_for_each_reference)

    for name, view, plain in _strided_cases(dev, dtype):
        dense = plain.contiguous()
        before, classic = FOR_EACH_STRIDED_TILED.launches, FOR_EACH_STRIDED.launches
        got = for_each(lambda p: p * 2, view)
        assert FOR_EACH_STRIDED_TILED.launches == before + 1, name
        assert torch.equal(got, dense * 2), name
        assert torch.equal(strided_for_each(lambda p: p * 2, [view], route="classic"), got)
        assert FOR_EACH_STRIDED.launches == classic + 1, name
        other = torch.ones_like(dense)
        got2 = for_each(lambda p, q: p + q - p * q, view, other)
        assert torch.equal(got2, strided_for_each_reference(lambda p, q: p + q - p * q,
                                                            [view, other])), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols,step", [(64, 4096, 2), (33, 1024, 3), (8, 8, 2),
                                            (1000, 12, 2)])
def test_strided_rows_vector_and_scalar_paths(dev, dtype, rows, cols, step):
    """Every step-th row: rows of whole aligned vectors take the vector
    path, others (12 f32 columns are 48 bytes, 12 bf16 24) the scalar one."""
    from laser_tpu_torch.ops.foreach import for_each
    from laser_tpu_torch.ops.strided import strided_for_each

    x = _rnd(_gen(dev, 66), (rows, cols), dtype, dev)
    body = lambda p: torch.sin(p) * 2.0 + 1.0  # noqa: E731
    for off in (0, 1):
        v = x[off::step]
        got = for_each(body, v)
        assert torch.equal(got, body(v))
        assert torch.equal(strided_for_each(body, [v], route="classic"), got)


def _strided_more_cases(dev):
    """(name, operands) beyond ``_strided_cases``: 1 to MAX_IN operands of
    every second row, bf16 operands beside f32 ones, a base one element off
    a 16-byte boundary, 3-D and 5-D views, rows of one vector and of 48
    bytes, and x[1::2] of 16384 x 4096 f32 (phase 14's case) cut to 512
    rows."""
    from laser_tpu_torch.ops.codegen import MAX_IN
    from laser_tpu_torch.tensor import TensorView

    g = _gen(dev, 70)
    a = _rnd(g, (64, 4096), torch.float32, dev)
    cases = [(f"{k}_operands", [_rnd(g, (64, 256), torch.float32, dev)[1::2]
                                for _ in range(k)]) for k in (1, 2, 3, 5, MAX_IN)]
    b16 = _rnd(g, (64, 256), torch.bfloat16, dev)
    cases += [
        ("bf16_and_f32", [b16[1::2], _rnd(g, (32, 256), torch.float32, dev)]),
        ("bf16_two", [b16[::2], b16[1::2]]),
        ("unaligned_base", [TensorView(a.reshape(-1), (32, 4000), (8192, 1), 4097)]),
        ("3d_view", [_rnd(g, (6, 40, 36), torch.float32, dev)[1::2, 3:35, 4:]]),
        ("5d_view", [_rnd(g, (3, 4, 5, 6, 8), torch.float32, dev)[:, ::2, 1:, ::3, :]]),
        ("one_vector_rows", [_rnd(g, (300, 4), torch.float32, dev)[::3]]),
        ("rows_48_bytes", [_rnd(g, (300, 12), torch.float32, dev)[1::2]]),
        ("phase14_rows", [_rnd(g, (1024, 4096), torch.float32, dev)[1::2]]),
    ]
    return cases


def _sum_body(*xs):
    """x0 * 2 - x1 + x2 * x3 - ...: every operand read, no FMA to contract"""
    acc = xs[0] * 2.0
    for i, x in enumerate(xs[1:]):
        acc = acc - x if i % 2 == 0 else acc + x * 0.5
    return acc


def test_strided_tiled_against_classic_and_plain(dev):
    """The tiled kernel (the default) against the classic kernel asked for
    and the plain version, bit for bit, with 1 to MAX_IN operands, bf16
    operands, an unaligned base, 3-D and 5-D views and short rows; each
    call one launch of its route's kernel."""
    from laser_tpu_torch.ops.strided import (FOR_EACH_STRIDED, FOR_EACH_STRIDED_TILED,
                                             strided_for_each, strided_for_each_reference)

    for name, ops in _strided_more_cases(dev):
        before, classic = FOR_EACH_STRIDED_TILED.launches, FOR_EACH_STRIDED.launches
        got = strided_for_each(_sum_body, ops)
        assert FOR_EACH_STRIDED_TILED.launches == before + 1, name
        old = strided_for_each(_sum_body, ops, route="classic")
        assert FOR_EACH_STRIDED.launches == classic + 1, name
        assert strided_for_each(_sum_body, ops).data_ptr() != got.data_ptr()
        want = strided_for_each_reference(_sum_body, ops)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), name
        assert torch.equal(old, want), name
        assert FOR_EACH_STRIDED_TILED.launches == before + 2, name


def test_strided_body_reads_its_globals_on_every_call(dev):
    """The strided plan is memoised on what the body reads: a closure and a
    global constant changed between calls give this call's value on the
    card."""
    from laser_tpu_torch.ops.foreach import for_each

    global _STRIDED_SCALE
    x = _rnd(_gen(dev, 71), (64, 512), torch.float32, dev)[1::2]
    shift = 1.0
    body = lambda p: p * _STRIDED_SCALE + shift  # noqa: E731
    for scale, sh in ((2.0, 1.0), (3.0, 1.0), (3.0, -4.0)):
        _STRIDED_SCALE, shift = scale, sh
        assert torch.equal(for_each(body, x), x * scale + sh)


_STRIDED_SCALE = 2.0


def _custom_block(ctx, b):
    """count of positives and sum of negatives (laser_tpu's
    tests/test_foreach.py:173-195, in torch): reduction depth 1"""
    pos = (b > 0) & ctx.valid
    neg = (b < 0) & ctx.valid
    return {"npos": pos.float().sum(), "sneg": torch.where(neg, b, 0.0).sum()}


def _custom_combine(a, b):
    return {"npos": a["npos"] + b["npos"], "sneg": a["sneg"] + b["sneg"]}


@pytest.mark.parametrize("n", [1, 1000, 4096, 4097, 300001])
def test_map_reduce_staged_depths_and_tail(dev, n):
    """A body of reduction depth 1 (count and sum) and of depth 2
    (mean_var, argmax) on a ragged tail: against the plain version, and the
    same bits on a second run."""
    from laser_tpu_torch.ops import reductions as R
    from laser_tpu_torch.ops.foreach import (MAP_REDUCE_STAGED_ONE, map_reduce_staged,
                                             map_reduce_staged_reference)

    x = _rnd(_gen(dev, 67), (n,), torch.float32, dev) * 3 + 1
    before = MAP_REDUCE_STAGED_ONE.launches
    got = map_reduce_staged(_custom_block, x, combine=_custom_combine)
    want = map_reduce_staged_reference(_custom_block, x, combine=_custom_combine)
    assert MAP_REDUCE_STAGED_ONE.launches == before + 1
    assert got["npos"].item() == want["npos"].item() == (x > 0).sum().item()
    assert abs(got["sneg"].item() - want["sneg"].item()) <= 1e-6 * x.abs().sum().item()
    m, v = R.mean_var(x)
    m64, v64 = x.double().mean().item(), x.double().var(unbiased=False).item()
    assert abs(m.item() - m64) <= 1e-5 * abs(m64) and abs(v.item() - v64) <= 1e-5 * v64
    m2, v2 = R.mean_var(x)
    assert torch.equal(m, m2) and torch.equal(v, v2)
    x[n // 2] = x[n // 3] = 1e6  # the maximum twice: the first one wins
    i, val = R.argmax(x)
    assert i.item() == (n // 3 if n > 2 else 0)
    assert val.item() == x.max().item()
    j, mn = R.argmin(x)
    assert j.item() == x.argmin().item() and mn.item() == x.min().item()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.bfloat16, torch.float16,
                                   torch.int64])
def test_arg_reductions_every_dtype(dev, dtype):
    from laser_tpu_torch.ops import reductions as R

    x = _any(_gen(dev, 68), (37, 301), dtype, dev)
    for f, ref in ((R.argmax, torch.argmax), (R.argmin, torch.argmin)):
        i, v = f(x)
        assert i.dtype == torch.int64 and v.dtype == dtype
        assert i.item() == ref(x).item() and v.item() == x.reshape(-1)[i].item()


def test_map_reduce_staged_strided_operand_and_bf16_leaf(dev):
    """A strided operand is materialised first; a bf16 leaf is stored as
    bf16 and combined in it; max and min of a block and mean of a block."""
    from laser_tpu_torch.ops.foreach import map_reduce_staged, map_reduce_staged_reference

    x = _rnd(_gen(dev, 69), (300, 70), torch.bfloat16, dev)[::2, 3:]

    def block(ctx, b):
        return (torch.amax(torch.where(ctx.valid, b, -1e4)), torch.mean(b.float()),
                torch.min(torch.where(ctx.valid, b, 1e4)))

    def comb(a, b):
        return (torch.maximum(a[0], b[0]), a[1] + b[1], torch.minimum(a[2], b[2]))

    got = map_reduce_staged(block, x, combine=comb)
    want = map_reduce_staged_reference(block, x.contiguous(), combine=comb)
    assert got[0].dtype == torch.bfloat16 and got[0].item() == x.max().item()
    assert got[2].item() == x.min().item()
    assert abs(got[1].item() - want[1].item()) <= 1e-5 * max(abs(want[1].item()), 1.0)


def _staged_runs(x, route):
    """mean_var, argmax, argmin and the custom body on ``x`` on one route,
    every leaf as a tensor."""
    from laser_tpu_torch.ops import reductions as R
    from laser_tpu_torch.ops.foreach import map_reduce_staged

    return [*R.mean_var(x, route=route), *R.argmax(x, route=route), *R.argmin(x, route=route),
            *map_reduce_staged(_custom_block, x, combine=_custom_combine,
                               route=route).values()]


def _same_leaves(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(-1).view(torch.uint8).cpu(),
                                                  w.view(-1).view(torch.uint8).cpu())


@pytest.mark.parametrize("n", [1, 1000, 4096, 4097, 300001, 4096 * 1500 + 3, 4096 * 2600 + 77])
def test_map_reduce_staged_one_launch_bits(dev, n):
    """The one-launch route against the two-launch template asked for:
    the same bits for mean_var, argmax (its maximum twice), argmin and the
    custom body, below one block, on ragged tails and past 1024 and 2048
    blocks (the fold's chains), run after run; one counted launch a call."""
    from laser_tpu_torch import registry

    x = _rnd(_gen(dev, 70), (n,), torch.float32, dev) * 3 + 1
    x[n // 2] = x[n // 3] = 1e6
    classic = _staged_runs(x, "classic")
    registry.reset_counts()
    one = _staged_runs(x, None)
    counts = registry.counts()
    assert counts["map_reduce_staged_one"]["launches"] == 4
    assert sum(c["launches"] for c in counts.values()) == 4
    _same_leaves(one, classic)
    _same_leaves(_staged_runs(x, None), one)
    assert one[2].item() == (n // 3 if n > 2 else 0)


def test_map_reduce_staged_one_launch_bf16_leaf_and_two_operands(dev):
    """A bf16 leaf stored and combined as bf16, block max / mean / min, and
    two operands of different dtypes: the same bits on both routes."""
    from laser_tpu_torch.ops.foreach import map_reduce_staged

    g = _gen(dev, 71)
    x = _rnd(g, (300, 7001), torch.bfloat16, dev)
    y = _rnd(g, (300, 7001), torch.float32, dev)

    def block(ctx, a, b):
        return (torch.amax(torch.where(ctx.valid, a, -1e4)), torch.mean(a.float() * b),
                torch.min(torch.where(ctx.valid, b, 1e4)))

    def comb(a, b):
        return (torch.maximum(a[0], b[0]), a[1] + b[1], torch.minimum(a[2], b[2]))

    got = map_reduce_staged(block, x, y, combine=comb)
    want = map_reduce_staged(block, x, y, combine=comb, route="classic")
    assert got[0].dtype == torch.bfloat16 and got[0].item() == x.max().item()
    _same_leaves(list(got), list(want))


def test_map_reduce_staged_one_launch_two_streams(dev):
    """Reductions on two streams at once, interleaved: each stream's
    counter is its own, so every result equals the classic route's."""
    from laser_tpu_torch.ops import reductions as R

    g = _gen(dev, 72)
    xs = [_rnd(g, (4096 * 700 + 9,), torch.float32, dev) * (i + 1) + i for i in range(2)]
    want = [_staged_runs(x, "classic") for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(6):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(_staged_runs(xs[i], None))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            _same_leaves(got, want[i])
    # and on the default stream after both
    _same_leaves(_staged_runs(xs[0], None), want[0])
    assert R.mean_var(xs[1])[0].item() == want[1][0].item()


def test_map_reduce_staged_one_launch_graph_replay(dev):
    """Captured in a CUDA graph, the default route runs the two-launch
    template (no counter for replays to share): replayed several times, on
    new data each time, the classic route's results on that data; eager
    calls after it take the one launch again and are still right."""
    from laser_tpu_torch import registry

    g = _gen(dev, 73)
    x = _rnd(g, (4096 * 1100 + 5,), torch.float32, dev)
    _staged_runs(x, None)  # build and warm up before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _staged_runs(x, None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    registry.reset_counts()
    with torch.cuda.graph(graph):
        captured = [_staged_runs(x, None) for _ in range(3)]
    counts = registry.counts()
    assert counts["map_reduce_staged"]["launches"] == 12
    assert counts["map_reduce_staged_one"]["launches"] == 0
    for rep in range(4):
        x.copy_(_rnd(g, x.shape, torch.float32, dev) * (rep + 1) - rep)
        graph.replay()
        torch.cuda.synchronize()
        want = _staged_runs(x, "classic")
        for got in captured:
            _same_leaves(got, want)
    registry.reset_counts()
    _same_leaves(_staged_runs(x, None), want)
    assert registry.counts()["map_reduce_staged_one"]["launches"] == 4


# ---------------------------------------------------------------------------
# The GEMM dtype table: the int8 GEMM, the batched GEMM, the limb and int32
# kernels, int64 and f64 through them, int8 quantization. Integer outputs
# and quantization are held to their plain versions bit for bit.
# ---------------------------------------------------------------------------

def _int8(g, shape, dev, extreme=False):
    if extreme:
        return torch.full(shape, -128, dtype=torch.int8, device=dev)
    return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)


def _equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())


def _int8_launches():
    """Launches of the int8 GEMM over its two routes."""
    from laser_tpu_torch.ops.gemm.kernel import I8_ROUTE_KERNELS

    return sum(k.launches for k in I8_ROUTE_KERNELS.values())


def _limb_launches(module):
    """Launches of the limb (or int32) kernel over its two routes."""
    return sum(k.launches for k in module.ROUTE_KERNELS.values())


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 100, 33), (17, 15, 64), (64, 16, 1),
                                   (130, 257, 65), (33, 4096, 17)])
def test_gemm_int8(dev, ta, tb, shape):
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    M, K, N = shape
    g = _gen(dev, 70)
    a = _int8(g, (K, M) if ta else (M, K), dev)
    b = _int8(g, (N, K) if tb else (K, N), dev)
    before = _int8_launches()
    got = gemm_fused(a, b, transpose_a=ta, transpose_b=tb)
    assert _int8_launches() == before + 1 and got.dtype == torch.int32
    _equal(got, gemm_plain(a, b, transpose_a=ta, transpose_b=tb))


@pytest.mark.parametrize("epilogue,out_dtype", [(None, torch.int32), ("relu", torch.int32),
                                                ("tanh", torch.float32),
                                                ("sigmoid", torch.float32),
                                                (None, torch.float32), ("relu", torch.bfloat16)])
def test_gemm_int8_epilogue_wraps(dev, epilogue, out_dtype):
    """alpha, beta * C and the bias wrap mod 2^32 in int32; 0.5 casts to 0."""
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    g = _gen(dev, 71)
    M, K, N = 45, 99, 70
    a, b = _int8(g, (M, K), dev), _int8(g, (K, N), dev)
    c = torch.randint(-2**31, 2**31 - 1, (M, N), generator=g, device=dev, dtype=torch.int32)
    bias = torch.randint(-2**31, 2**31 - 1, (N,), generator=g, device=dev, dtype=torch.int32)
    for alpha, beta in ((3, -7), (0.5, 1.5), (2**31 - 1, -2**31)):
        kw = dict(alpha=alpha, beta=beta, c=c, bias=bias, epilogue=epilogue,
                  out_dtype=out_dtype)
        got, want = gemm_fused(a, b, **kw), gemm_plain(a, b, **kw)
        if out_dtype == torch.int32 or epilogue is None:
            _equal(got, want)
        else:
            _check(got, want, torch.float32 if out_dtype == torch.float32 else torch.bfloat16)


def test_gemm_int8_accumulator_wraps(dev):
    """All -128 over K = 140000: the int32 sum passes 2^31 and wraps, on the
    WMMA kernel and on the wgmma route alike."""
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    a, b = _int8(None, (3, 140000), dev, True), _int8(None, (140000, 5), dev, True)
    want = gemm_plain(a, b)
    for route in (None, "classic", "wgmma"):
        got = gemm_fused(a, b, route=route)
        _equal(got, want)
        assert got[0, 0].item() == (140000 * 16384 + 2**31) % 2**32 - 2**31


def test_gemm_int8_unaligned_operands(dev):
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    g = _gen(dev, 72)
    M, K, N = 40, 64, 48
    a = _int8(g, (M * K + 1,), dev)[1:].view(M, K)
    b = _int8(g, (K * N + 1,), dev)[1:].view(K, N)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _equal(gemm_fused(a, b), gemm_plain(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 20, 37, 19), (2, 130, 64, 70)])
def test_gemm_batched(dev, dtype, shape):
    from laser_tpu_torch.ops.gemm.batched import ROUTE_KERNELS, gemm_batched, gemm_batched_plain

    B, M, K, N = shape
    g = _gen(dev, 73)
    if dtype == torch.int8:
        a, b = _int8(g, (B, M, K), dev), _int8(g, (B, K, N), dev)
    else:
        a, b = _rnd(g, (B, M, K), dtype, dev), _rnd(g, (B, K, N), dtype, dev, std=K ** -0.5)
    before = sum(k.launches for k in ROUTE_KERNELS.values())
    got = gemm_batched(a, b)
    assert sum(k.launches for k in ROUTE_KERNELS.values()) == before + 1
    want = gemm_batched_plain(a, b, got.dtype)
    if dtype == torch.int8:
        _equal(got, want)
    else:
        _check(got, want, dtype)


def test_gemm_batched_past_the_grid_limit(dev):
    """65537 entries: two launches (gridDim.z is at most 65535)."""
    from laser_tpu_torch.ops.gemm.batched import GEMM_BATCHED, gemm_batched, gemm_batched_plain

    g = _gen(dev, 74)
    a, b = _int8(g, (65537, 2, 3), dev), _int8(g, (65537, 3, 2), dev)
    before = GEMM_BATCHED.launches
    got = gemm_batched(a, b)
    assert GEMM_BATCHED.launches == before + 2
    _equal(got, gemm_batched_plain(a, b, torch.int32))


@pytest.mark.parametrize("planes", [(8, 8, 8), (4, 4, 4), (3, 5, 6), (1, 1, 1), (8, 8, 1)])
@pytest.mark.parametrize("shape", [(1, 1, 1), (33, 31, 65), (32, 32, 64), (40, 100, 17),
                                   (7, 8192, 9)])
def test_gemm_limbs(dev, planes, shape):
    from laser_tpu_torch.ops.gemm import limb_kernel
    from laser_tpu_torch.ops.gemm.limb_kernel import gemm_limbs, gemm_limbs_plain

    nA, nB, nb = planes
    M, K, N = shape
    g = _gen(dev, 75)
    da, db = _int8(g, (nA, M, K), dev), _int8(g, (nB, K, N), dev)
    before = _limb_launches(limb_kernel)
    got = gemm_limbs(da, db, nb)
    assert _limb_launches(limb_kernel) == before + 1
    _equal(got, gemm_limbs_plain(da, db, nb))


def test_gemm_limbs_extreme_digits(dev):
    """Every digit -128 at K = 8192, the int64 chunk: the largest bucket
    is 8 * 8192 * 2^14 = 2^30, exact."""
    from laser_tpu_torch.ops.gemm.limb_kernel import gemm_limbs, gemm_limbs_plain

    da, db = _int8(None, (8, 5, 8192), dev, True), _int8(None, (8, 8192, 3), dev, True)
    got = gemm_limbs(da, db, 8)
    _equal(got, gemm_limbs_plain(da, db, 8))
    assert got[7, 0, 0].item() == 8 * 8192 * 16384


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 100, 7), (64, 257, 130), (1, 4096, 33)])
@pytest.mark.parametrize("extreme", [False, True])
def test_gemm_int32_kernel(dev, shape, extreme):
    from laser_tpu_torch.ops.gemm import int32_kernel
    from laser_tpu_torch.ops.gemm.int32_kernel import (gemm_int32, gemm_int32_limbs_plain,
                                                       int32_limbs)

    M, K, N = shape
    g = _gen(dev, 76)
    lims = (-2**31, 2**31 - 1)

    def rnd(*s):
        if extreme:
            pool = torch.tensor([lims[0], lims[1], -1, 0, 1], device=dev, dtype=torch.int32)
            return pool[torch.randint(0, 5, s, generator=g, device=dev)]
        return torch.randint(*lims, s, generator=g, device=dev, dtype=torch.int32)

    a, b, c = rnd(M, K), rnd(K, N), rnd(M, N)
    for alpha, beta, cc in ((1, 0, None), (lims[0], lims[1], c), (-3, 7, c)):
        before = _limb_launches(int32_kernel)
        got = gemm_int32(a, b, alpha=alpha, beta=beta, c=cc)
        assert _limb_launches(int32_kernel) == before + 1
        _equal(got, gemm_int32_limbs_plain(int32_limbs(a), int32_limbs(b), alpha, beta, cc))
    ua, ub = a.view(torch.uint32), b.view(torch.uint32)
    _equal(gemm_int32(ua, ub).view(torch.int32), gemm_int32(a, b))


def test_int64_and_f64_gemm_match_the_cpu_route(dev):
    """int64 across the 8192 K-chunk with alpha, beta and C, uint64, and
    f64 (8 and 4 slices, a zero row) give the CPU route's result: the
    same digits, the same bucket sums, the same combine."""
    from laser_tpu_torch.ops.gemm import gemm, limb_kernel
    from laser_tpu_torch.ops.gemm.f64_kernel import gemm_f64

    g = torch.Generator().manual_seed(77)
    a = torch.randint(-2**63, 2**63 - 1, (6, 8200), generator=g, dtype=torch.int64)
    b = torch.randint(-2**63, 2**63 - 1, (8200, 5), generator=g, dtype=torch.int64)
    c = torch.randint(-2**63, 2**63 - 1, (6, 5), generator=g, dtype=torch.int64)
    before = (limb_kernel.GEMM_LIMBS.launches, limb_kernel.GEMM_LIMBS_WGMMA.launches)
    got = gemm(a.to(dev), b.to(dev), alpha=3, beta=-5, c=c.to(dev))
    # two K chunks: 8192 on the wgmma route, the 8-deep tail on the classic
    # kernel (K-major B planes)
    assert (limb_kernel.GEMM_LIMBS.launches, limb_kernel.GEMM_LIMBS_WGMMA.launches) == \
        (before[0] + 1, before[1] + 1)
    _equal(got, gemm(a, b, alpha=3, beta=-5, c=c))
    _equal(gemm(a.to(dev).view(torch.uint64), b.to(dev).view(torch.uint64)),
           gemm(a.view(torch.uint64), b.view(torch.uint64)))
    af = torch.randn(17, 300, generator=g, dtype=torch.float64) * torch.exp2(
        torch.randint(-30, 30, (17, 300), generator=g).double())
    bf = torch.randn(300, 11, generator=g, dtype=torch.float64)
    af[3] = 0.0
    for slices in (8, 4):
        got = gemm_f64(af.to(dev), bf.to(dev), slices=slices)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), gemm_f64(af, bf, slices=slices))
        assert bool((got[3] == 0).all())


@pytest.mark.parametrize("shape", [(1, 1), (1, 5000), (37, 100), (4096, 3), (300, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_int8(dev, shape, dtype, per_row, stochastic):
    from laser_tpu_torch.ops.quant import QUANTIZE, quantize_int8, quantize_int8_plain

    x = _rnd(_gen(dev, 78), shape, dtype, dev, std=4.0)
    x[0, 0] = 0.0
    before = QUANTIZE.launches
    q, s = quantize_int8(x, per_row=per_row, stochastic=stochastic, seed=11)
    assert QUANTIZE.launches == before + 1
    wq, ws = quantize_int8_plain(x, per_row, stochastic, 11)
    _equal(s, ws)
    _equal(q, wq)


def test_quantize_int8_zero_row_and_gemm_quantized(dev):
    from laser_tpu_torch.ops.quant import gemm_quantized, quantize_int8, quantize_int8_plain

    g = _gen(dev, 79)
    x = _rnd(g, (9, 300), torch.float32, dev)
    x[4] = 0.0
    q, s = quantize_int8(x)
    _equal(s, quantize_int8_plain(x)[1])
    assert bool((q[4] == 0).all())
    a, b = _rnd(g, (70, 130), torch.float32, dev), _rnd(g, (130, 45), torch.float32, dev)
    got = gemm_quantized(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gemm_quantized(a.cpu(), b.cpu()))


# ---------------------------------------------------------------------------
# The int8 wgmma skeleton (csrc/wgmma_gemm.cuh with wgmma s8): the int8 GEMM's
# route, the limb product's and the int32 GEMM's. Each is held bit for bit to
# its plain version and to the classic WMMA kernel it replaces.
# ---------------------------------------------------------------------------

def _routes_equal(run, want, counter, routes=("wgmma", "classic")):
    """run(route) on each route equals ``want`` bit for bit; the wgmma run
    counts one launch on ``counter``."""
    before = counter.launches
    got = {r: run(r) for r in routes}
    assert counter.launches == before + 1
    for r in routes:
        _equal(got[r], want)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", [(1, 16, 1), (37, 48, 45), (64, 128, 64), (130, 272, 257),
                                   (200, 4096, 129), (65, 8192, 33)])
def test_gemm_i8_wgmma(dev, ta, tb, shape):
    """Ragged M and N, K a multiple of 16 but not of 128, every transposition:
    the wgmma route against the plain version and the WMMA kernel."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM_I8_WGMMA, gemm_fused, gemm_plain

    M, K, N = shape
    g = _gen(dev, 90)
    a = _int8(g, (K, M) if ta else (M, K), dev)
    b = _int8(g, (N, K) if tb else (K, N), dev)
    kw = dict(transpose_a=ta, transpose_b=tb)
    _routes_equal(lambda r: gemm_fused(a, b, route=r, **kw), gemm_plain(a, b, **kw),
                  GEMM_I8_WGMMA)


@pytest.mark.parametrize("epilogue,out_dtype", [(None, torch.int32), ("relu", torch.int32),
                                                ("tanh", torch.float32),
                                                ("sigmoid", torch.float32),
                                                ("gelu", torch.bfloat16),
                                                (None, torch.float32), ("relu", torch.bfloat16),
                                                (None, torch.float16)])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)])
def test_gemm_i8_wgmma_epilogues(dev, epilogue, out_dtype, ta, tb):
    """alpha, beta * C and the bias (INT_MIN / INT_MAX among them) wrap mod
    2^32 on the wgmma route as on the WMMA kernel: the same bits, and the
    plain version's (float outputs of an activation within a rounding)."""
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    g = _gen(dev, 91)
    M, K, N = 131, 96, 70
    a = _int8(g, (K, M) if ta else (M, K), dev)
    b = _int8(g, (N, K) if tb else (K, N), dev)
    c = torch.randint(-2**31, 2**31 - 1, (M, N), generator=g, device=dev, dtype=torch.int32)
    c[0, :4] = torch.tensor([-2**31, 2**31 - 1, -1, 0], dtype=torch.int32)
    bias = torch.randint(-2**31, 2**31 - 1, (N,), generator=g, device=dev, dtype=torch.int32)
    for alpha, beta in ((3, -7), (0.5, 1.5), (2**31 - 1, -2**31)):
        kw = dict(alpha=alpha, beta=beta, c=c, bias=bias, epilogue=epilogue,
                  out_dtype=out_dtype, transpose_a=ta, transpose_b=tb)
        got = gemm_fused(a, b, route="wgmma", **kw)
        _equal(got, gemm_fused(a, b, route="classic", **kw))
        want = gemm_plain(a, b, **kw)
        if out_dtype == torch.int32 or epilogue is None:  # f16 overflows to inf alike
            _equal(got, want)
        else:
            _check(got, want, torch.float32 if out_dtype == torch.float32 else torch.bfloat16)


@pytest.mark.parametrize("value", [-128, 127])
def test_gemm_i8_wgmma_extreme_digits(dev, value):
    """Every operand -128 (or 127) at K 4096 and a mix of both at K 8192:
    the largest products, the same bits on both routes."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM_I8_WGMMA, gemm_fused, gemm_plain

    a = torch.full((70, 4096), value, dtype=torch.int8, device=dev)
    b = torch.full((4096, 66), value, dtype=torch.int8, device=dev)
    _routes_equal(lambda r: gemm_fused(a, b, route=r), gemm_plain(a, b), GEMM_I8_WGMMA)
    g = _gen(dev, 92)
    pool = torch.tensor([-128, 127], dtype=torch.int8, device=dev)
    a, b = (pool[torch.randint(0, 2, s, generator=g, device=dev)] for s in ((65, 8192),
                                                                            (8192, 40)))
    _routes_equal(lambda r: gemm_fused(a, b, route=r), gemm_plain(a, b), GEMM_I8_WGMMA)


def test_gemm_i8_wgmma_more_tiles_than_blocks(dev):
    """1056 output tiles (4224 x 4096) for two blocks on each SM: the
    persistent grid walks several tiles a block."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM_I8_WGMMA, gemm_fused, gemm_plain

    g = _gen(dev, 93)
    a, b = _int8(g, (4224, 64), dev), _int8(g, (64, 4096), dev)
    _routes_equal(lambda r: gemm_fused(a, b, route=r), gemm_plain(a, b), GEMM_I8_WGMMA)


def test_gemm_i8_routes_by_shape_and_asked_for(dev):
    """The library picks wgmma for int8 at any M with K % 16 == 0 (the
    bench row and gemm_quantized), the WMMA kernel for other K; a route
    that does not fit raises, an unknown name raises ValueError."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.gemm.batched import gemm_batched, _gemm_batched_cuda
    from laser_tpu_torch.ops.gemm.kernel import GEMM, GEMM_I8_WGMMA, gemm_fused
    from laser_tpu_torch.ops.quant import gemm_quantized

    g = _gen(dev, 94)
    for (M, K), counter in (((64, 64), GEMM_I8_WGMMA), ((1, 64), GEMM_I8_WGMMA),
                            ((300, 72), GEMM), ((300, 80), GEMM_I8_WGMMA)):
        before = counter.launches
        gemm_fused(_int8(g, (M, K), dev), _int8(g, (K, 40), dev))
        assert counter.launches == before + 1, (M, K)
    before = GEMM_I8_WGMMA.launches
    gemm_quantized(_rnd(g, (128, 256), torch.float32, dev), _rnd(g, (256, 48), torch.float32, dev))
    assert GEMM_I8_WGMMA.launches == before + 1
    a, b = _int8(g, (80, 72), dev), _int8(g, (72, 40), dev)
    with pytest.raises(registry.KernelLaunchError):  # K % 16 != 0
        gemm_fused(a, b, route="wgmma")
    au = _int8(g, (80 * 64 + 1,), dev)[1:].view(80, 64)
    with pytest.raises(registry.KernelLaunchError):  # A read in place, unaligned
        gemm_fused(au, _int8(g, (64, 40), dev), route="wgmma")
    for route in ("splitk", "simt"):
        with pytest.raises(registry.KernelLaunchError):
            gemm_fused(au, _int8(g, (64, 40), dev), route=route)
    with pytest.raises(ValueError):
        gemm_fused(a, b, route="tensor")
    ab, bb = _int8(g, (2, 80, 64), dev), _int8(g, (2, 64, 40), dev)
    with pytest.raises(registry.KernelLaunchError):  # the batched int8 product: WMMA only
        _gemm_batched_cuda(ab, bb, torch.int32, route="wgmma")
    before = GEMM_I8_WGMMA.launches
    gemm_batched(ab, bb)
    assert GEMM_I8_WGMMA.launches == before


@pytest.mark.parametrize("planes", [(8, 8, 8), (4, 4, 4), (3, 5, 6), (1, 1, 1), (8, 8, 1),
                                    (2, 7, 8), (6, 1, 3), (1, 2, 5)])
@pytest.mark.parametrize("shape", [(1, 16, 1), (33, 48, 65), (130, 272, 257), (7, 8192, 9)])
def test_gemm_limbs_wgmma(dev, planes, shape):
    """Planes 1-8 a side, nA != nB, buckets past the last pair (zero planes),
    ragged M and N, K off 128 and at the int64 chunk boundary (8192): the
    wgmma route, from (nB, K, N) planes and from K-major ones, against the
    plain version and the WMMA kernel."""
    from laser_tpu_torch.ops.gemm.limb_kernel import (GEMM_LIMBS_WGMMA, gemm_limbs,
                                                      gemm_limbs_kmajor, gemm_limbs_plain)

    nA, nB, nb = planes
    M, K, N = shape
    g = _gen(dev, 95)
    da, db = _int8(g, (nA, M, K), dev), _int8(g, (nB, K, N), dev)
    want = gemm_limbs_plain(da, db, nb)
    _routes_equal(lambda r: gemm_limbs(da, db, nb, route=r), want, GEMM_LIMBS_WGMMA)
    dbt = db.transpose(1, 2).contiguous()
    _routes_equal(lambda r: gemm_limbs_kmajor(da, dbt, nb, route=r), want, GEMM_LIMBS_WGMMA)


@pytest.mark.parametrize("slices", [8, 4])
def test_gemm_limbs_wgmma_f64_chunk(dev, slices):
    """The f64 GEMM's K chunk (32768) with digits in its range, [-64, 64]."""
    from laser_tpu_torch.ops.gemm.limb_kernel import (GEMM_LIMBS_WGMMA, gemm_limbs,
                                                      gemm_limbs_plain, max_k_for)

    K = max_k_for(slices, 64)
    g = _gen(dev, 100)
    da = torch.randint(-64, 65, (slices, 129, K), generator=g, device=dev, dtype=torch.int8)
    db = torch.randint(-64, 65, (slices, K, 130), generator=g, device=dev, dtype=torch.int8)
    _routes_equal(lambda r: gemm_limbs(da, db, slices, route=r),
                  gemm_limbs_plain(da, db, slices), GEMM_LIMBS_WGMMA)


def test_gemm_limbs_wgmma_extreme_digits(dev):
    """Every digit -128 at K = 8192: the largest bucket, 2^30, exact."""
    from laser_tpu_torch.ops.gemm.limb_kernel import GEMM_LIMBS_WGMMA, gemm_limbs, gemm_limbs_plain

    da, db = _int8(None, (8, 5, 8192), dev, True), _int8(None, (8, 8192, 3), dev, True)
    want = gemm_limbs_plain(da, db, 8)
    _routes_equal(lambda r: gemm_limbs(da, db, 8, route=r), want, GEMM_LIMBS_WGMMA)
    assert want[7, 0, 0].item() == 8 * 8192 * 16384


def test_gemm_limbs_more_tiles_than_blocks(dev):
    """1056 tiles of 8 x 8 planes into 8 buckets at K 32."""
    from laser_tpu_torch.ops.gemm.limb_kernel import GEMM_LIMBS_WGMMA, gemm_limbs, gemm_limbs_plain

    g = _gen(dev, 96)
    da, db = _int8(g, (8, 4224, 32), dev), _int8(g, (8, 32, 4096), dev)
    _routes_equal(lambda r: gemm_limbs(da, db, 8, route=r), gemm_limbs_plain(da, db, 8),
                  GEMM_LIMBS_WGMMA)


@pytest.mark.parametrize("shape", [(1, 16, 1), (5, 112, 7), (64, 272, 130), (130, 4096, 33)])
@pytest.mark.parametrize("extreme", [False, True])
def test_gemm_int32_wgmma(dev, shape, extreme):
    """INT_MIN / INT_MAX operands, alpha, beta and C, uint32: the wgmma
    route (the Horner sum of the 4 buckets) against the plain version and
    the WMMA kernel, from (4, K, N) limbs and from K-major ones, and
    gemm_int32 on the route it picks."""
    from laser_tpu_torch.ops.gemm.int32_kernel import (GEMM_INT32_WGMMA, gemm_int32,
                                                       gemm_int32_limbs,
                                                       gemm_int32_limbs_kmajor,
                                                       gemm_int32_limbs_plain, int32_limbs)

    M, K, N = shape
    g = _gen(dev, 97)
    lims = (-2**31, 2**31 - 1)

    def rnd(*s):
        if extreme:
            pool = torch.tensor([lims[0], lims[1], -1, 0, 1], device=dev, dtype=torch.int32)
            return pool[torch.randint(0, 5, s, generator=g, device=dev)]
        return torch.randint(*lims, s, generator=g, device=dev, dtype=torch.int32)

    a, b, c = rnd(M, K), rnd(K, N), rnd(M, N)
    la, lb, lbt = int32_limbs(a), int32_limbs(b), int32_limbs(b.t())
    for alpha, beta, cc in ((1, 0, None), (lims[0], lims[1], c), (-3, 7, c)):
        want = gemm_int32_limbs_plain(la, lb, alpha, beta, cc)
        _routes_equal(lambda r: gemm_int32_limbs(la, lb, alpha, beta, cc, route=r), want,
                      GEMM_INT32_WGMMA)
        _routes_equal(lambda r: gemm_int32_limbs_kmajor(la, lbt, alpha, beta, cc, route=r),
                      want, GEMM_INT32_WGMMA)
        _equal(gemm_int32(a, b, alpha=alpha, beta=beta, c=cc), want)
    ua, ub = a.view(torch.uint32), b.view(torch.uint32)
    _equal(gemm_int32(ua, ub).view(torch.int32), gemm_int32(a, b))


def test_limb_routes_by_shape_and_asked_for(dev):
    """K % 16 != 0 or an unaligned plane takes the WMMA kernel (raises when
    wgmma is asked for); an unknown route raises ValueError."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.gemm import int32_kernel, limb_kernel

    g = _gen(dev, 98)
    da, db = _int8(g, (3, 20, 100), dev), _int8(g, (4, 100, 30), dev)
    before = limb_kernel.GEMM_LIMBS.launches
    got = limb_kernel.gemm_limbs(da, db, 6)
    assert limb_kernel.GEMM_LIMBS.launches == before + 1
    _equal(got, limb_kernel.gemm_limbs_plain(da, db, 6))
    with pytest.raises(registry.KernelLaunchError):
        limb_kernel.gemm_limbs(da, db, 6, route="wgmma")
    dbt = _int8(g, (4 * 30 * 96 + 1,), dev)[1:].view(4, 30, 96)
    with pytest.raises(registry.KernelLaunchError):
        limb_kernel.gemm_limbs_kmajor(_int8(g, (3, 20, 96), dev), dbt, 6, route="wgmma")
    la, lb = _int8(g, (4, 9, 100), dev), _int8(g, (4, 100, 11), dev)
    with pytest.raises(registry.KernelLaunchError):
        int32_kernel.gemm_int32_limbs(la, lb, route="wgmma")
    for fn in (lambda: limb_kernel.gemm_limbs(da, db, 6, route="mma"),
               lambda: int32_kernel.gemm_int32_limbs(la, lb, route="mma")):
        with pytest.raises(ValueError):
            fn()


def test_int8_kmajor_copies_are_transpose_launches(dev):
    """Each K-major copy the int8 kernels need is a ``transpose`` launch of
    its own, counted: ``gemm`` int8 on a row-major B or a transposed A (not
    on the WMMA route asked for, which reads them in place), ``gemm_limbs``
    and ``gemm_int32_limbs`` on laser_tpu's (n, K, N) planes on either
    route; none where the operands come K-major."""
    from laser_tpu_torch.ops.gemm import int32_kernel, limb_kernel
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused
    from laser_tpu_torch.ops.transpose import TRANSPOSE

    g = _gen(dev, 101)
    a, b = _int8(g, (64, 96), dev), _int8(g, (96, 48), dev)
    at, bt = a.t().contiguous(), b.t().contiguous()
    da, db = _int8(g, (3, 20, 96), dev), _int8(g, (4, 96, 30), dev)
    dbt = db.transpose(1, 2).contiguous()
    x, y = (torch.randint(-2**31, 2**31 - 1, s, generator=g, device=dev, dtype=torch.int32)
            for s in ((9, 96), (96, 11)))
    la, lb = int32_kernel.int32_limbs(x), int32_kernel.int32_limbs(y)
    for tag, run, copies in (
            ("B row-major", lambda: gemm_fused(a, b), 1),
            ("A transposed, B row-major", lambda: gemm_fused(at, b, transpose_a=True), 2),
            ("B transposed", lambda: gemm_fused(a, bt, transpose_b=True), 0),
            ("WMMA asked for", lambda: gemm_fused(at, b, transpose_a=True, route="classic"), 0),
            ("gemm_limbs", lambda: limb_kernel.gemm_limbs(da, db, 6), 1),
            ("gemm_limbs classic", lambda: limb_kernel.gemm_limbs(da, db, 6, route="classic"),
             1),
            ("gemm_limbs_kmajor", lambda: limb_kernel.gemm_limbs_kmajor(da, dbt, 6), 0),
            ("gemm_int32_limbs", lambda: int32_kernel.gemm_int32_limbs(la, lb), 1),
            ("gemm_int32", lambda: int32_kernel.gemm_int32(x, y), 0)):
        before = TRANSPOSE.launches
        run()
        assert TRANSPOSE.launches == before + copies, tag


def test_int64_and_f64_on_the_wgmma_route(dev):
    """int64 at K 16384 (two chunks, both on the wgmma route) with alpha,
    beta and C, and f64 at K 4096 (8 and 4 slices): the CPU route's bits."""
    from laser_tpu_torch.ops.gemm import gemm, limb_kernel
    from laser_tpu_torch.ops.gemm.f64_kernel import gemm_f64

    g = torch.Generator().manual_seed(99)
    a = torch.randint(-2**63, 2**63 - 1, (70, 16384), generator=g, dtype=torch.int64)
    b = torch.randint(-2**63, 2**63 - 1, (16384, 33), generator=g, dtype=torch.int64)
    c = torch.randint(-2**63, 2**63 - 1, (70, 33), generator=g, dtype=torch.int64)
    before = limb_kernel.GEMM_LIMBS_WGMMA.launches
    _equal(gemm(a.to(dev), b.to(dev), alpha=3, beta=-5, c=c.to(dev)),
           gemm(a, b, alpha=3, beta=-5, c=c))
    assert limb_kernel.GEMM_LIMBS_WGMMA.launches == before + 2
    af = torch.randn(130, 4096, generator=g, dtype=torch.float64) * torch.exp2(
        torch.randint(-30, 30, (130, 4096), generator=g).double())
    bf = torch.randn(4096, 70, generator=g, dtype=torch.float64)
    for slices in (8, 4):
        before = limb_kernel.GEMM_LIMBS_WGMMA.launches
        got = gemm_f64(af.to(dev), bf.to(dev), slices=slices)
        torch.cuda.synchronize()
        assert limb_kernel.GEMM_LIMBS_WGMMA.launches == before + 1
        assert torch.equal(got.cpu(), gemm_f64(af, bf, slices=slices))


# ---------------------------------------------------------------------------
# The library surface: the fused optimizer updates (csrc/optim.cu), the
# stencil sweeps (csrc/stencil.cu) and the packed GEMM (csrc/packed_gemm.cu)
# ---------------------------------------------------------------------------

def _hyper(lr, wd):
    from laser_tpu_torch.ops.optim import _bias_corrections

    bc1, bc2 = _bias_corrections(3, 0.9, 0.999)
    return dict(lr=lr, b1=0.9, b2=0.999, omb1=float(1.0 - 0.9), omb2=float(1.0 - 0.999),
                eps=1e-8, wd=wd, bc1=bc1, bc2=bc2, has_wd=wd != 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1,), (37,), (3, 5, 7), (1000003,)])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("offset", [0, 1])  # 1: unaligned operands, the scalar path
def test_adamw_update_bit_identical(dev, dtype, shape, wd, offset):
    from laser_tpu_torch.ops.optim import ADAMW, adamw_update, adamw_update_plain

    g = _gen(dev, 80)
    n = math.prod(shape)

    def leaf(std=1.0, positive=False):
        x = torch.randn(n + offset, generator=g, device=dev) * std
        x = x.abs() if positive else x
        return x.to(dtype)[offset:].reshape(shape)

    p, gr, m, v = leaf(), leaf(), leaf(0.1), leaf(0.01, positive=True)
    want = [t.clone() for t in (p, gr, m, v)]
    lr = torch.tensor(3e-4, device=dev) if offset else 3e-4
    before = ADAMW.launches
    adamw_update(p, gr, m, v, **_hyper(lr, wd))
    assert ADAMW.launches == before + 1
    adamw_update_plain(*want, **_hyper(lr, wd))
    for got, ref in zip((p, m, v), (want[0], want[2], want[3])):
        _equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1,), (37,), (3, 5, 7), (1000003,)])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgdm_update_bit_identical(dev, dtype, shape, nesterov):
    """One leaf: the multi-tensor kernel on a one-leaf table and the
    per-leaf kernel asked for, both bit for bit against the plain version."""
    from laser_tpu_torch.ops.optim import SGDM, SGDM_MULTI, sgdm_update, sgdm_update_plain

    g = _gen(dev, 81)
    p, gr, m = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
    want = [t.clone() for t in (p, gr, m)]
    classic = [t.clone() for t in (p, gr, m)]
    before, before_classic = SGDM_MULTI.launches, SGDM.launches
    sgdm_update(p, gr, m, lr=0.05, mu=0.9, nesterov=nesterov)
    assert SGDM_MULTI.launches == before + 1
    sgdm_update(*classic, lr=0.05, mu=0.9, nesterov=nesterov, route="classic")
    assert SGDM.launches == before_classic + 1
    sgdm_update_plain(*want, lr=0.05, mu=0.9, nesterov=nesterov)
    for got in ((p, m), (classic[0], classic[2])):
        _equal(got[0], want[0])
        _equal(got[1], want[2])


def _sgd_tree(dev, seed, n_leaves=None):
    """p, g, m trees of f32, bf16 and f16 leaves: odd sizes, one-element
    and empty leaves, leaves at an element offset into their buffer (not
    16-byte aligned: the scalar path), a 2-D leaf; or ``n_leaves`` small
    f32 leaves."""
    g = _gen(dev, seed)

    def leaf(shape, dtype, offset=0):
        n = math.prod(shape)
        return (torch.randn(n + offset, generator=g, device=dev).to(dtype)[offset:]
                .view(shape))

    if n_leaves is not None:
        specs = [((1 + i % 37,), torch.float32, i % 2) for i in range(n_leaves)]
    else:
        specs = [((37,), torch.float32, 0), ((1,), torch.bfloat16, 0), ((0,), torch.float16, 0),
                 ((3, 5, 7), torch.bfloat16, 1), ((1000003,), torch.float16, 0),
                 ((4096,), torch.float32, 1), ((513, 8), torch.bfloat16, 0),
                 ((0, 4), torch.float32, 0), ((129,), torch.float16, 3)]
    return [{f"l{i:04d}": leaf(*spec) for i, spec in enumerate(specs)} for _ in range(3)]


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgdm_multi_tree_bit_identical(dev, nesterov):
    """A tree of three dtypes (one launch each), unaligned views, one-element
    and empty leaves, lr as a CUDA 0-d tensor: every leaf bit for bit against
    the plain version and the per-leaf kernel."""
    from laser_tpu_torch.ops import optim

    p, gr, m = _sgd_tree(dev, 83)
    plain = [optim.tree_map(torch.clone, t) for t in (p, gr, m)]
    classic = [optim.tree_map(torch.clone, t) for t in (p, gr, m)]
    lr = torch.tensor(0.05, device=dev)
    before = optim.SGDM_MULTI.launches
    optim.sgd_momentum_step(p, gr, m, lr=lr, nesterov=nesterov, backend="pallas")
    assert optim.SGDM_MULTI.launches == before + 3
    optim.sgd_momentum_step(*classic, lr=lr, nesterov=nesterov, backend="pallas",
                            route="classic")
    for pp, gg, mm in zip(*(optim.tree_leaves(t) for t in plain), strict=True):
        optim.sgdm_update_plain(pp, gg, mm, lr=lr, mu=0.9, nesterov=nesterov)
    for want in (plain, classic):
        for a, b in zip(optim.tree_leaves((p, m)), optim.tree_leaves((want[0], want[2])),
                        strict=True):
            _equal(a, b)


def test_sgdm_multi_more_leaves_than_one_table(dev):
    """Past SGDM_TABLE_LEAVES leaves of one dtype the step takes a launch a
    table, every leaf bit for bit."""
    from laser_tpu_torch.ops import optim

    n = 2 * optim.SGDM_TABLE_LEAVES + 5
    p, gr, m = _sgd_tree(dev, 84, n_leaves=n)
    plain = [optim.tree_map(torch.clone, t) for t in (p, gr, m)]
    before = optim.SGDM_MULTI.launches
    optim.sgd_momentum_step(p, gr, m, lr=0.01, backend="pallas")
    assert optim.SGDM_MULTI.launches == before + 3
    for pp, gg, mm in zip(*(optim.tree_leaves(t) for t in plain), strict=True):
        optim.sgdm_update_plain(pp, gg, mm, lr=0.01, mu=0.9, nesterov=False)
    for a, b in zip(optim.tree_leaves((p, m)), optim.tree_leaves((plain[0], plain[2])),
                    strict=True):
        _equal(a, b)


def test_sgdm_multi_in_a_cuda_graph(dev):
    """A step captured in a CUDA graph, lr read through its pointer: two
    replays with the lr changed between them give two plain steps' bits."""
    from laser_tpu_torch.ops import optim

    p, gr, m = _sgd_tree(dev, 85)
    plain = [optim.tree_map(torch.clone, t) for t in (p, gr, m)]
    lr = torch.tensor(0.05, device=dev)
    step = lambda: optim.sgd_momentum_step(p, gr, m, lr=lr, nesterov=True,  # noqa: E731
                                           backend="pallas")
    warm = [optim.tree_map(torch.clone, t) for t in (p, m)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, then undone
        step()
    torch.cuda.current_stream().wait_stream(side)
    for dst, src in zip(optim.tree_leaves((p, m)), optim.tree_leaves(warm), strict=True):
        dst.copy_(src)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for value in (0.05, 0.02):
        lr.fill_(value)
        graph.replay()
        for pp, gg, mm in zip(*(optim.tree_leaves(t) for t in plain), strict=True):
            optim.sgdm_update_plain(pp, gg, mm, lr=value, mu=0.9, nesterov=True)
    for a, b in zip(optim.tree_leaves((p, m)), optim.tree_leaves((plain[0], plain[2])),
                    strict=True):
        _equal(a, b)


def test_optimizer_steps_on_the_card_match_the_cpu_route(dev):
    """A tree of f32 and bf16 leaves, a schedule's lr on the card and a
    tensor step: adamw_step and sgd_momentum_step (backend="pallas") on the
    card give the CPU route's bits; a moment of another dtype comes back in
    the parameter's."""
    from laser_tpu_torch.ops import optim

    g = torch.Generator().manual_seed(82)
    tree = lambda: {"a": torch.randn(37, generator=g),  # noqa: E731
                    "b": torch.randn(3, 5, 7, generator=g).bfloat16()}
    p, grads = tree(), tree()
    to = lambda t, d: optim.tree_map(lambda x: x.to(d), t)  # noqa: E731
    m, v = optim.adamw_init(p)
    m["b"] = m["b"].float()
    cp, cm, cv = to(p, dev), to(m, dev), to(v, dev)
    for step in (1, 2, 3):
        p, m, v = optim.adamw_step(p, grads, m, v, step, lr=torch.tensor(1e-2),
                                   weight_decay=0.1, backend="pallas")
        cp, cm, cv = optim.adamw_step(cp, to(grads, dev), cm, cv,
                                      torch.tensor(step, device=dev),
                                      lr=torch.tensor(1e-2, device=dev), weight_decay=0.1,
                                      backend="pallas")
    assert cm["b"].dtype == torch.bfloat16
    # the bias corrections differ by at most an ulp between the card's pow and the host's
    for a, b in zip(optim.tree_leaves((cp, cm, cv)), optim.tree_leaves((p, m, v))):
        torch.cuda.synchronize()
        assert a.dtype == b.dtype
        assert (a.cpu().float() - b.float()).abs().max().item() <= 1e-5 * b.float().abs().max()
    mp, mm = to(p, dev), to(m, dev)
    for nesterov in (False, True):
        optim.sgd_momentum_step(p, grads, m, lr=0.05, nesterov=nesterov, backend="pallas")
        optim.sgd_momentum_step(mp, to(grads, dev), mm, lr=0.05, nesterov=nesterov,
                                backend="pallas")
    for a, b in zip(optim.tree_leaves((mp, mm)), optim.tree_leaves((p, m))):
        _equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(3, 3), (2, 5), (12, 16), (33, 65), (257, 130)])
@pytest.mark.parametrize("method", ["redblack", "jacobi"])
@pytest.mark.parametrize("iters", [1, 2, 5])
def test_stencil_bit_identical(dev, dtype, shape, method, iters):
    from laser_tpu_torch.ops.stencil import STENCIL, stencil_solve, stencil_sweeps_plain

    g = _gen(dev, 83)
    u, f = _rnd(g, shape, dtype, dev), _rnd(g, shape, dtype, dev, std=0.5)
    u0 = u.clone()
    before = STENCIL.launches
    got = stencil_solve(u, f, iters=iters, method=method)
    interior = min(shape) >= 3
    assert STENCIL.launches == before + (iters * (2 if method == "redblack" else 1)
                                         if interior else 0)
    _equal(got, stencil_sweeps_plain(u, f, iters, method))
    _equal(u, u0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("plan", ["planned", (48, 80, 40), (256, 128, 64), (128, 256, 32)])
@pytest.mark.parametrize("shape", [(1, 1, 1), (100, 120, 90), (130, 257, 200)])
def test_gemm_packed(dev, dtype, plan, shape):
    from laser_tpu_torch.ops.gemm import GemmTiles, gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import (GEMM_PACKED, GEMM_PACKED_I8_WGMMA,
                                                    GEMM_PACKED_SIMT, GEMM_PACKED_WGMMA,
                                                    gemm_packed_plain, simt_route, wgmma_route)

    M, N, K = shape
    g = _gen(dev, 84)
    if dtype == torch.int8:
        a = torch.randint(-128, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        c = torch.randint(-2**31, 2**31 - 1, (M, N), generator=g, device=dev, dtype=torch.int32)
        alpha, beta = 3, -2
    else:
        a, b = _rnd(g, (M, K), dtype, dev), _rnd(g, (K, N), dtype, dev, std=K ** -0.5)
        c, alpha, beta = _rnd(g, (M, N), torch.float32, dev), 0.5, -1.5
    tiles = None if plan == "planned" else GemmTiles(*plan, vmem_limit_bytes=0)
    pa, pb = gemm_prepack_a(a, tiles=tiles), gemm_prepack_b(b, tiles=tiles)
    cpu_pa = gemm_prepack_a(a.cpu(), tiles=tiles)
    _equal(pa.data, cpu_pa.data)  # the packed bytes do not depend on the device
    # the 16-bit and int8 products on planned and wide plans take their wgmma
    # routes, the f32 ones the simt route
    plan = (dtype, pa.block[0], pb.block[1], pa.block[1])
    wgmma = GEMM_PACKED_I8_WGMMA if dtype == torch.int8 else GEMM_PACKED_WGMMA
    kern = wgmma if wgmma_route(*plan) else GEMM_PACKED_SIMT if simt_route(*plan) \
        else GEMM_PACKED
    for cc in (None, c):
        before = kern.launches
        got = gemm_packed(alpha, pa, pb, beta, cc)
        assert kern.launches == before + 1
        acc = torch.int32 if dtype == torch.int8 else torch.float32
        want = gemm_packed_plain(alpha, pa, pb, beta, cc, dtype, acc, got.dtype)
        if dtype == torch.int8:
            _equal(got, want)
        else:
            _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("plan", ["planned", (256, 128, 64), (128, 256, 128)])
@pytest.mark.parametrize("shape", [(100, 120, 90), (130, 257, 200), (384, 256, 320)])
@pytest.mark.parametrize("to_f32", [False, True])
def test_gemm_packed_wgmma(dev, dtype, plan, shape, to_f32):
    """The wgmma route over the packed blocks, with and without beta * C,
    at M, N, K off the plan (zero padding inert, the epilogue masked),
    against the plain version; only its counter moves."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.gemm import GemmTiles, gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import gemm_packed_plain

    M, N, K = shape
    g = _gen(dev, 86)
    a, b = _rnd(g, (M, K), dtype, dev), _rnd(g, (K, N), dtype, dev, std=K ** -0.5)
    c = _rnd(g, (M, N), torch.float32, dev)
    tiles = None if plan == "planned" else GemmTiles(*plan, vmem_limit_bytes=0)
    pa, pb = gemm_prepack_a(a, tiles=tiles), gemm_prepack_b(b, tiles=tiles)
    out_dtype = torch.float32 if to_f32 else dtype
    for cc in (None, c):
        registry.reset_counts()
        got = gemm_packed(0.5, pa, pb, -1.5, cc, out_dtype=out_dtype)
        counts = registry.counts()
        assert counts["gemm_packed_wgmma"]["launches"] == 1
        assert sum(v["launches"] for v in counts.values()) == 1
        _check(got, gemm_packed_plain(0.5, pa, pb, -1.5, cc, dtype, torch.float32, out_dtype),
               out_dtype)


def test_gemm_packed_routes_asked_for(dev):
    """"classic" runs the blocks kernels on a plan wgmma takes; "wgmma"
    raises on the ODD plan (which the library keeps on the gather route)
    and on f32; an unknown route raises."""
    from laser_tpu_torch.ops.gemm import GemmTiles, gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import (GEMM_PACKED, GEMM_PACKED_WGMMA,
                                                    gemm_packed_plain)

    g = _gen(dev, 87)
    a, b = _rnd(g, (100, 90), torch.bfloat16, dev), _rnd(g, (90, 120), torch.bfloat16, dev)
    pa, pb = gemm_prepack_a(a), gemm_prepack_b(b)
    want = gemm_packed_plain(1.0, pa, pb, 0.0, None, torch.bfloat16, torch.float32,
                             torch.bfloat16)
    before, wg = GEMM_PACKED.launches, GEMM_PACKED_WGMMA.launches
    _check(gemm_packed(1.0, pa, pb, route="classic"), want, torch.bfloat16)
    _check(gemm_packed(1.0, pa, pb, route="wgmma"), want, torch.bfloat16)
    assert (GEMM_PACKED.launches, GEMM_PACKED_WGMMA.launches) == (before + 1, wg + 1)
    odd = GemmTiles(48, 80, 40, vmem_limit_bytes=0)
    po, qo = gemm_prepack_a(a, tiles=odd), gemm_prepack_b(b, tiles=odd)
    before = GEMM_PACKED.launches
    _check(gemm_packed(1.0, po, qo), want, torch.bfloat16)
    assert (GEMM_PACKED.launches, GEMM_PACKED_WGMMA.launches) == (before + 1, wg + 1)
    with pytest.raises(ValueError, match="wgmma"):
        gemm_packed(1.0, po, qo, route="wgmma")
    with pytest.raises(ValueError, match="wgmma"):
        gemm_packed(1.0, gemm_prepack_a(a.float()), gemm_prepack_b(b.float()), route="wgmma")
    with pytest.raises(ValueError, match="unknown route"):
        gemm_packed(1.0, pa, pb, route="mma")


def test_gemm_packed_out_dtypes_and_int8_alpha(dev):
    """bf16 inputs to an f32 output; int8 to f32 (a cast after the int32
    kernel); an int8 alpha of 0.5 is 0, as laser_tpu casts it."""
    from laser_tpu_torch.ops.gemm import gemm_packed, gemm_prepack_a, gemm_prepack_b

    g = _gen(dev, 85)
    a, b = _rnd(g, (70, 64), torch.bfloat16, dev), _rnd(g, (64, 50), torch.bfloat16, dev)
    got = gemm_packed(1.0, gemm_prepack_a(a), gemm_prepack_b(b), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _check(got, a.float() @ b.float(), torch.float32)
    ai = torch.randint(-128, 128, (70, 64), generator=g, device=dev, dtype=torch.int8)
    bi = torch.randint(-128, 128, (64, 50), generator=g, device=dev, dtype=torch.int8)
    pa, pb = gemm_prepack_a(ai), gemm_prepack_b(bi)
    _equal(gemm_packed(1, pa, pb, out_dtype=torch.float32),
           (ai.double() @ bi.double()).float())
    assert not bool(gemm_packed(0.5, pa, pb).any())


@pytest.mark.parametrize("plan", ["planned", (256, 128, 128), (128, 384, 256)])
@pytest.mark.parametrize("shape", [(1, 1, 1), (100, 120, 90), (130, 257, 200), (384, 256, 640)])
def test_gemm_packed_i8_wgmma(dev, plan, shape):
    """The int8 wgmma route over packed A and B's K-major twin at M, N, K
    off the plan (padded blocks, the epilogue masked), with alpha 1, 3 and
    -1 and beta * C over the whole int32 range: bit for bit against
    packed_i8_kernel asked for and against the plain version; only its
    counter moves."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.gemm import GemmTiles, gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import gemm_packed_plain

    M, N, K = shape
    g = _gen(dev, 88)
    a = torch.randint(-128, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    c = torch.randint(-2**31, 2**31 - 1, (M, N), generator=g, device=dev, dtype=torch.int32)
    tiles = None if plan == "planned" else GemmTiles(*plan, vmem_limit_bytes=0)
    pa, pb = gemm_prepack_a(a, tiles=tiles), gemm_prepack_b(b, tiles=tiles)
    assert torch.equal(pb.kmajor, pb.data.transpose(-1, -2))
    for alpha, beta, cc in ((1, 0, None), (3, -2, c), (-1, 7, c)):
        registry.reset_counts()
        got = gemm_packed(alpha, pa, pb, beta, cc)
        counts = registry.counts()
        assert counts["gemm_packed_i8_wgmma"]["launches"] == 1
        assert sum(v["launches"] for v in counts.values()) == 1
        _equal(got, gemm_packed(alpha, pa, pb, beta, cc, route="classic"))
        assert registry.counts()["gemm_packed"]["launches"] == 1
        _equal(got, gemm_packed(alpha, pa, pb, beta, cc, route="wgmma"))
        _equal(got, gemm_packed_plain(alpha, pa, pb, beta, cc, torch.int8, torch.int32,
                                      torch.int32))


def test_gemm_packed_i8_wgmma_accumulator_wraps(dev):
    """K = 131200 of -128 x -128: every dot product is 16384 K = 2149580800,
    past INT32_MAX, and wraps mod 2^32 as the classic kernel's and the plain
    version's; ragged M and N."""
    from laser_tpu_torch.ops.gemm import gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import GEMM_PACKED_I8_WGMMA, gemm_packed_plain

    M, N, K = 130, 136, 131200
    a = torch.full((M, K), -128, device=dev, dtype=torch.int8)
    b = torch.full((K, N), -128, device=dev, dtype=torch.int8)
    b[:, 5] = 127
    pa, pb = gemm_prepack_a(a), gemm_prepack_b(b)
    before = GEMM_PACKED_I8_WGMMA.launches
    got = gemm_packed(1, pa, pb)
    assert GEMM_PACKED_I8_WGMMA.launches == before + 1
    wrap = lambda v: (v + 2**31) % 2**32 - 2**31  # noqa: E731
    torch.cuda.synchronize()
    assert got[0, 0].item() == wrap(16384 * K) and got[-1, 5].item() == wrap(-128 * 127 * K)
    _equal(got, gemm_packed(1, pa, pb, route="classic"))
    _equal(got, gemm_packed_plain(1, pa, pb, 0, None, torch.int8, torch.int32, torch.int32))


def test_gemm_packed_i8_wgmma_refuses_what_it_does_not_take(dev):
    """route="wgmma" raises on an int8 plan off its tile (the ODD plan, bk
    64), on a B without its K-major twin and on misaligned data; the library
    runs those on the classic kernels."""
    import dataclasses

    from laser_tpu_torch.ops.gemm import GemmTiles, gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import GEMM_PACKED, gemm_packed_plain

    g = _gen(dev, 89)
    a = torch.randint(-128, 128, (100, 90), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-128, 128, (90, 120), generator=g, device=dev, dtype=torch.int8)
    for tiles in (GemmTiles(48, 80, 40, 0), GemmTiles(128, 128, 64, 0), None):
        pa, pb = gemm_prepack_a(a, tiles=tiles), gemm_prepack_b(b, tiles=tiles)
        if tiles is None:
            pb = dataclasses.replace(pb, kmajor=None)
        else:  # off the route's tile: packing made no twin
            assert (pb.kmajor is None) == (tiles.bk % 128 != 0 or tiles.bn % 128 != 0)
        want = gemm_packed_plain(1, pa, pb, 0, None, torch.int8, torch.int32, torch.int32)
        before = GEMM_PACKED.launches
        _equal(gemm_packed(1, pa, pb), want)
        assert GEMM_PACKED.launches == before + 1
        with pytest.raises(ValueError, match="wgmma"):
            gemm_packed(1, pa, pb, route="wgmma")


# ---------------------------------------------------------------------------
# The Hopper routes: the wgmma GEMM (csrc/gemm.cu gemm_wgmma_kernel) and the
# tensor-core flash forward (csrc/flash_attention.cu flash_fwd_mma_kernel),
# each against its plain version, each asserting which route's counter moved
# ---------------------------------------------------------------------------

def _gemm_route(M, K, N, ta, tb):
    """The route the library should pick for 16-bit operands with M > 40 (no
    split-K): wgmma where both operands' contiguous dimensions are
    multiples of 8."""
    a_inner, b_inner = (M if ta else K), (K if tb else N)
    return "wgmma" if M > 40 and a_inner % 8 == 0 and b_inner % 8 == 0 else "classic"


def _gemm_counters(route):
    from laser_tpu_torch.ops.gemm.kernel import GEMM, GEMM_WGMMA

    return (GEMM_WGMMA, GEMM) if route == "wgmma" else (GEMM, GEMM_WGMMA)


# (M, K, N, epilogue): every M of {65, 128, 4092}, K of {8, 72, 2048}, N of
# {8, 200, 8192} and every epilogue, ragged in each dimension
WGMMA_SHAPES = [(65, 72, 200, "gelu"), (128, 8, 8, "relu"), (4092, 2048, 8192, "tanh"),
                (128, 72, 8192, "sigmoid"), (4092, 8, 200, None), (65, 2048, 8, "gelu")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=lambda s: "x".join(map(str, s[:3])))
def test_gemm_wgmma(dev, dtype, ta, tb, shape):
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    M, K, N, epilogue = shape
    g = _gen(dev, 80)
    a = _rnd(g, (K, M) if ta else (M, K), dtype, dev)
    b = _rnd(g, (N, K) if tb else (K, N), dtype, dev, std=K ** -0.5)
    bias = _rnd(g, (N,), dtype, dev)
    kw = dict(bias=bias, epilogue=epilogue, transpose_a=ta, transpose_b=tb)
    route = _gemm_route(M, K, N, ta, tb)
    moved, other = _gemm_counters(route)
    before = (moved.launches, other.launches)
    _check(gemm_fused(a, b, **kw), gemm_plain(a, b, **kw), dtype)
    assert (moved.launches, other.launches) == (before[0] + 1, before[1]), route


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32)])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
def test_gemm_wgmma_alpha_beta_c_out_dtypes(dev, in_dtype, out_dtype, ta, tb):
    """alpha * op(A) op(B) + beta * C + bias, one cast to each output type,
    as the LM loss calls it (fp32 out, c = the running sum, beta 1)."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM_WGMMA, gemm_fused, gemm_plain

    M, K, N = 200, 136, 264
    g = _gen(dev, 81)
    a = _rnd(g, (K, M) if ta else (M, K), in_dtype, dev)
    b = _rnd(g, (N, K) if tb else (K, N), in_dtype, dev, std=K ** -0.5)
    c = _rnd(g, (M, N), torch.float32, dev)
    bias = _rnd(g, (N,), torch.float32, dev)
    kw = dict(alpha=0.75, beta=-1.5, c=c, bias=bias, epilogue="relu", out_dtype=out_dtype,
              transpose_a=ta, transpose_b=tb)
    before = GEMM_WGMMA.launches
    got, want = gemm_fused(a, b, **kw), gemm_plain(a, b, **kw)
    assert GEMM_WGMMA.launches == before + 1
    _check(got, want, out_dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gemm_batched_wgmma(dev, dtype):
    """B = 3 at a ragged size: the batch entry is the tensor maps' third
    coordinate; no tile reads across two entries."""
    from laser_tpu_torch.ops.gemm.batched import (GEMM_BATCHED, GEMM_BATCHED_WGMMA,
                                                  gemm_batched, gemm_batched_plain)

    g = _gen(dev, 82)
    a, b = _rnd(g, (3, 130, 72), dtype, dev), _rnd(g, (3, 72, 200), dtype, dev, std=72 ** -0.5)
    before = (GEMM_BATCHED_WGMMA.launches, GEMM_BATCHED.launches)
    got = gemm_batched(a, b)
    assert (GEMM_BATCHED_WGMMA.launches, GEMM_BATCHED.launches) == (before[0] + 1, before[1])
    want = gemm_batched_plain(a, b, got.dtype)
    _check(got, want, dtype)
    for i in range(3):  # each entry against its own product
        _check(got[i], gemm_batched_plain(a[i:i + 1], b[i:i + 1], dtype)[0], dtype)


def test_gemm_k_not_a_multiple_of_8_takes_wmma(dev):
    """K % 8 != 0 cannot be a TMA stride: the WMMA kernel runs, right."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM, GEMM_WGMMA, gemm_fused, gemm_plain

    g = _gen(dev, 83)
    a, b = _rnd(g, (300, 70), torch.bfloat16, dev), _rnd(g, (70, 136), torch.bfloat16, dev)
    before = (GEMM.launches, GEMM_WGMMA.launches)
    _check(gemm_fused(a, b), gemm_plain(a, b), torch.bfloat16)
    assert (GEMM.launches, GEMM_WGMMA.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("M", [1, 8, 40])
def test_gemm_wgmma_asked_for_at_decode_rows(dev, M):
    """route="wgmma" runs the wgmma kernel below its M threshold (the
    decode products' crossover is timed that way), where the library picks
    split-K; route="classic" the WMMA kernel above it. All right."""
    from laser_tpu_torch.ops.gemm.kernel import (GEMM, GEMM_SPLITK, GEMM_WGMMA, gemm_fused,
                                                 gemm_plain)

    g = _gen(dev, 84)
    x, w = _rnd(g, (M, 2048), torch.bfloat16, dev), _rnd(g, (2048, 640), torch.bfloat16, dev,
                                                          std=2048 ** -0.5)
    bias = _rnd(g, (640,), torch.bfloat16, dev)
    want = gemm_plain(x, w, bias=bias)
    before = (GEMM.launches, GEMM_WGMMA.launches, GEMM_SPLITK.launches)
    _check(gemm_fused(x, w, bias=bias, route="wgmma"), want, torch.bfloat16)
    _check(gemm_fused(x, w, bias=bias), want, torch.bfloat16)
    assert (GEMM.launches, GEMM_WGMMA.launches, GEMM_SPLITK.launches) == (
        before[0], before[1] + 1, before[2] + 1)
    xb = _rnd(g, (256, 2048), torch.bfloat16, dev)
    _check(gemm_fused(xb, w, bias=bias, route="classic"), gemm_plain(xb, w, bias=bias),
           torch.bfloat16)
    assert GEMM.launches == before[0] + 1
    with pytest.raises(Exception):  # not a TMA stride: the route refuses
        gemm_fused(_rnd(g, (M, 70), torch.bfloat16, dev), _rnd(g, (70, 64), torch.bfloat16, dev),
                   route="wgmma")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 200, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_mma(dev, dtype, D, S, causal):
    """The tensor-core forward: with (m, l) over MHA heads, and value-only
    over GQA groups of 4, against the plain version."""
    from laser_tpu_torch.ops.attention import FLASH, FLASH_MMA, flash_forward

    g = _gen(dev, 85)
    scale = D ** -0.5
    q, k, v = (_rnd(g, (6, S, D), dtype, dev) for _ in range(3))
    before = (FLASH_MMA.launches, FLASH.launches)
    o, m, l = flash_forward(q, k, v, causal, scale, stats=True)
    assert (FLASH_MMA.launches, FLASH.launches) == (before[0] + 1, before[1])
    po, pm, pl = flash_forward(q, k, v, causal, scale, stats=True, plain=True)
    _check_rows(o, po, dtype)
    _check(m, pm, torch.float32)
    _check(l, pl, torch.float32)
    # GQA: 2 batch rows x 8 query heads over 2 kv heads each
    qg = _rnd(g, (16, S, D), dtype, dev)
    kg, vg = _rnd(g, (4, S, D), dtype, dev), _rnd(g, (4, S, D), dtype, dev)
    got = flash_forward(qg, kg, vg, causal, scale, kv_heads=(8, 2))
    assert FLASH_MMA.launches == before[0] + 2
    _check_rows(got, flash_forward(qg, kg, vg, causal, scale, kv_heads=(8, 2), plain=True),
                dtype)


def test_flash_routes_asked_for(dev):
    """route="ffma" runs the FFMA kernel on bf16 at D 128; f32 and D 96 take
    it by themselves; route="mma" refuses f32."""
    from laser_tpu_torch.ops.attention import FLASH, FLASH_MMA, flash_forward

    g = _gen(dev, 86)
    q, k, v = (_rnd(g, (4, 100, 128), torch.bfloat16, dev) for _ in range(3))
    before = (FLASH.launches, FLASH_MMA.launches)
    _check(flash_forward(q, k, v, True, 0.1, route="ffma"),
           flash_forward(q, k, v, True, 0.1, plain=True), torch.bfloat16)
    for dt, D in ((torch.float32, 128), (torch.bfloat16, 96)):
        x = _rnd(g, (4, 100, D), dt, dev)
        _check(flash_forward(x, x, x, False, 0.1), flash_forward(x, x, x, False, 0.1, plain=True),
               dt)
    assert (FLASH.launches, FLASH_MMA.launches) == (before[0] + 3, before[1])
    with pytest.raises(Exception):
        flash_forward(q.float(), k.float(), v.float(), True, 0.1, route="mma")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 45, 300, 1030])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_mma(dev, dtype, D, S, causal):
    """The tensor-core backward, asked for, against the FFMA kernels asked
    for and the plain version (P and dS rounded to the input dtype against
    fp32: within REL of each output's max); both mma counters move, and the
    library picks the same route by itself."""
    from laser_tpu_torch.ops.attention import flash_forward
    from laser_tpu_torch.ops.attention_bwd import (FLASH_BWD_DKV, FLASH_BWD_DKV_MMA,
                                                   FLASH_BWD_DQ, FLASH_BWD_DQ_MMA,
                                                   flash_attention_bwd,
                                                   flash_attention_bwd_reference)

    g = _gen(dev, 88)
    q, k, v, do = (_rnd(g, (4, S, D), dtype, dev) for _ in range(4))
    scale = D ** -0.5
    o, m, l = flash_forward(q, k, v, causal, scale, stats=True)

    def counts():
        return (FLASH_BWD_DQ_MMA.launches, FLASH_BWD_DKV_MMA.launches, FLASH_BWD_DQ.launches,
                FLASH_BWD_DKV.launches)

    before = counts()
    got = flash_attention_bwd(q, k, v, o, m, l, do, causal=causal, scale=scale, route="mma")
    assert counts() == (before[0] + 1, before[1] + 1, before[2], before[3])
    ffma = flash_attention_bwd(q, k, v, o, m, l, do, causal=causal, scale=scale, route="ffma")
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1)
    auto = flash_attention_bwd(q, k, v, o, m, l, do, causal=causal, scale=scale)
    assert counts() == (before[0] + 2, before[1] + 2, before[2] + 1, before[3] + 1)
    want = flash_attention_bwd_reference(q, k, v, o, m, l, do, causal=causal, scale=scale)
    for name, a, b, c, w in zip("qkv", got, ffma, auto, want):
        floor = 1.0 if S == 1 and name in "qk" else 1e-30
        _check(a, w, dtype, floor)
        _check(a, b, dtype, floor)
        assert torch.equal(a, c), name  # one route, one summation order


def test_flash_bwd_routes_asked_for(dev):
    """route="mma" refuses f32 and D 80 (the launcher returns an error, the
    wrapper raises); the library takes FFMA for them by itself."""
    from laser_tpu_torch.ops.attention import flash_forward
    from laser_tpu_torch.ops.attention_bwd import (FLASH_BWD_DKV_MMA, FLASH_BWD_DQ_MMA,
                                                   flash_attention_bwd)

    g = _gen(dev, 89)
    for dt, D in ((torch.float32, 128), (torch.bfloat16, 80)):
        q, k, v, do = (_rnd(g, (2, 70, D), dt, dev) for _ in range(4))
        o, m, l = flash_forward(q, k, v, True, 0.1, stats=True)
        before = (FLASH_BWD_DQ_MMA.launches, FLASH_BWD_DKV_MMA.launches)
        with pytest.raises(Exception):
            flash_attention_bwd(q, k, v, o, m, l, do, causal=True, scale=0.1, route="mma")
        flash_attention_bwd(q, k, v, o, m, l, do, causal=True, scale=0.1)
        torch.cuda.synchronize()
        assert (FLASH_BWD_DQ_MMA.launches, FLASH_BWD_DKV_MMA.launches) == before


@pytest.mark.parametrize("Sq,Sk,k_valid", [(16, 40, None), (40, 16, None), (16, 40, 23)])
def test_attention_with_stats_rectangular_raises_on_the_kernel(dev, Sq, Sk, k_valid):
    """Keys of their own length or k_valid: the plain version takes them
    (tests/test_torch_attention_rect.py); the kernel route raises."""
    from laser_tpu_torch.ops.attention import attention_with_stats

    g = _gen(dev, 87)
    q = _rnd(g, (2, Sq, 64), torch.bfloat16, dev)
    k, v = _rnd(g, (2, Sk, 64), torch.bfloat16, dev), _rnd(g, (2, Sk, 64), torch.bfloat16, dev)
    with pytest.raises(NotImplementedError):
        attention_with_stats(q, k, v, causal=True, k_valid=k_valid)
    with pytest.raises(ValueError):
        attention_with_stats(q, k, v, k_valid=0)


# ---------------------------------------------------------------------------
# The weight-streaming routes: the GEMM's split-K route for few rows
# (csrc/gemm.cu over csrc/splitk.cuh) and the int4 GEMM's stream and mma
# routes (csrc/w4_gemm.cu), each against its plain version, each asserting
# which route's counter moved
# ---------------------------------------------------------------------------

# (K, N, epilogue, with beta * C): K ragged against the 64-deep (f32: 32)
# k tile, the splits and the 8-element vectors; N ragged against the
# 128-column tile
SPLITK_SHAPES = [(1000, 200, "gelu", False), (999, 8, None, True), (4096, 392, "relu", True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("M", [1, 8, 16, 40, 63])
@pytest.mark.parametrize("shape", SPLITK_SHAPES, ids=lambda s: f"K{s[0]}xN{s[1]}")
def test_gemm_splitk(dev, dtype, M, shape):
    """route="splitk" at decode rows, bias and an activation, alpha != 1 with
    beta * C, against the plain version; only its counter moves."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM_SPLITK, gemm_fused, gemm_plain

    K, N, epilogue, with_c = shape
    if dtype == torch.float32:
        N = N - 4 if N > 8 else 4  # f32 asks only N % 4 == 0
    g = _gen(dev, 90)
    a = _rnd(g, (M, K), dtype, dev)
    b = _rnd(g, (K, N), dtype, dev, std=K ** -0.5)
    kw = dict(bias=_rnd(g, (N,), dtype, dev), epilogue=epilogue)
    if with_c:
        kw.update(alpha=0.75, beta=-1.5, c=_rnd(g, (M, N), torch.float32, dev))
    before = (GEMM_SPLITK.launches, _gemm_launches())
    got = gemm_fused(a, b, route="splitk", **kw)
    assert (GEMM_SPLITK.launches, _gemm_launches()) == (before[0] + 1, before[1] + 1)
    _check(got, gemm_plain(a, b, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 256), (40, 14336, 512), (16, 50176, 128)])
def test_gemm_splitk_same_bits_twice(dev, dtype, M, K, N):
    """Many splits (two column tiles over a long K; C1's head shape): the
    reduce sums them in a fixed order, so two calls give the same bits."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM_SPLITK, gemm_fused, gemm_plain

    g = _gen(dev, 91)
    a, b = _rnd(g, (M, K), dtype, dev), _rnd(g, (K, N), dtype, dev, std=K ** -0.5)
    before = GEMM_SPLITK.launches
    one, two = gemm_fused(a, b), gemm_fused(a, b)
    assert GEMM_SPLITK.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    _check(one, gemm_plain(a, b), dtype)


def test_gemm_small_m_takes_the_old_kernels_by_shape(dev):
    """At decode rows the library picks split-K for a plain product, and the
    WMMA kernel, by shape, for what split-K does not take: B transposed, A
    transposed, N % 8 != 0, a base off 16 bytes, batched. route="splitk"
    refuses those, and route="classic" still reaches the WMMA kernel."""
    from laser_tpu_torch.ops.gemm.batched import gemm_batched
    from laser_tpu_torch.ops.gemm.kernel import GEMM, GEMM_SPLITK, gemm_fused, gemm_plain

    g = _gen(dev, 92)
    bf = torch.bfloat16
    M, K, N = 8, 256, 96
    x, w = _rnd(g, (M, K), bf, dev), _rnd(g, (K, N), bf, dev, std=K ** -0.5)
    wt, xt = w.t().contiguous(), x.t().contiguous()
    xu = _rnd(g, (M * K + 1,), bf, dev)[1:].view(M, K)
    assert xu.data_ptr() % 16
    cases = [  # (args, kwargs, want)
        ((x, wt), dict(transpose_b=True), gemm_plain(x, w)),
        ((xt, w), dict(transpose_a=True), gemm_plain(x, w)),
        ((x, w[:, :90].contiguous()), {}, gemm_plain(x, w[:, :90])),
        ((xu, w), {}, gemm_plain(xu, w)),
    ]
    for args, kw, want in cases:
        before = (GEMM.launches, GEMM_SPLITK.launches)
        _check(gemm_fused(*args, **kw), want, bf)
        assert (GEMM.launches, GEMM_SPLITK.launches) == (before[0] + 1, before[1]), kw
        with pytest.raises(Exception):
            gemm_fused(*args, route="splitk", **kw)
    before = (GEMM.launches, GEMM_SPLITK.launches)
    _check(gemm_fused(x, w), gemm_plain(x, w), bf)
    _check(gemm_fused(x, w, route="classic"), gemm_plain(x, w), bf)
    assert (GEMM.launches, GEMM_SPLITK.launches) == (before[0] + 1, before[1] + 1)
    xb = torch.stack([x, x])
    _check(gemm_batched(xb, torch.stack([w, w])), torch.stack([gemm_plain(x, w)] * 2), bf)
    assert GEMM_SPLITK.launches == before[1] + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 8, 40, 64, 257])
@pytest.mark.parametrize("group", [2, 32, 64, 128])
def test_w4_gemm_routes(dev, dtype, M, group):
    """Both int4 routes asked for (stream up to 64 rows) and the library's
    pick, against the plain version: K past several groups and not a
    multiple of the 128-deep stream tile, N past the 128-column tile."""
    from laser_tpu_torch.ops.gemm.int4_kernel import (ROUTE_KERNELS, W4_GEMM_MMA,
                                                      W4_GEMM_STREAM, gemm_w4, gemm_w4_plain,
                                                      quantize_int4)

    g = _gen(dev, 93)
    K, N = 384 + 64 * (group <= 64), 272
    h = _rnd(g, (M, K), dtype, dev)
    wq = quantize_int4(_rnd(g, (K, N), torch.float32, dev, std=K ** -0.5), group=group)
    want = gemm_w4_plain(h, wq)
    routes = [("mma", W4_GEMM_MMA)] + ([("stream", W4_GEMM_STREAM)] if M <= 64 else [])
    for route, counter in routes:
        before = (counter.launches, sum(k.launches for k in ROUTE_KERNELS.values()))
        got = gemm_w4(h, wq, route=route)
        assert (counter.launches, sum(k.launches for k in ROUTE_KERNELS.values())) == (
            before[0] + 1, before[1] + 1), route
        _check(got, want, dtype)
    if M > 64:
        with pytest.raises(Exception):
            gemm_w4(h, wq, route="stream")
    before = (W4_GEMM_STREAM.launches, W4_GEMM_MMA.launches)
    _check(gemm_w4(h, wq), want, dtype)
    moved = (W4_GEMM_STREAM.launches - before[0], W4_GEMM_MMA.launches - before[1])
    assert moved in ((1, 0), (0, 1)) and (moved == (0, 1) or M <= 64)


def test_w4_gemm_stream_same_bits_twice(dev):
    """Llama-3-8B's w_down at 8 rows: many splits, the same bits twice."""
    from laser_tpu_torch.ops.gemm.int4_kernel import gemm_w4, gemm_w4_plain, quantize_int4

    g = _gen(dev, 94)
    h = _rnd(g, (8, 14336), torch.bfloat16, dev)
    wq = quantize_int4(_rnd(g, (14336, 512), torch.float32, dev, std=14336 ** -0.5))
    one, two = gemm_w4(h, wq, route="stream"), gemm_w4(h, wq, route="stream")
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    _check(one, gemm_w4_plain(h, wq), torch.bfloat16)


def test_w4_gemm_takes_the_classic_kernel_by_shape(dev):
    """N % 16 != 0, an activation off 16 bytes and f32 take the classic
    kernels, right; the new routes refuse them; route="classic" reaches the
    WMMA kernel at any M."""
    from laser_tpu_torch.ops.gemm.int4_kernel import (W4_GEMM, W4_GEMM_MMA, W4_GEMM_STREAM,
                                                      gemm_w4, gemm_w4_plain, quantize_int4)

    g = _gen(dev, 95)
    K = 256
    wq = quantize_int4(_rnd(g, (K, 200), torch.float32, dev, std=K ** -0.5), group=64)
    wq16 = quantize_int4(_rnd(g, (K, 208), torch.float32, dev, std=K ** -0.5), group=64)
    hu = _rnd(g, (8 * K + 1,), torch.bfloat16, dev)[1:].view(8, K)
    assert hu.data_ptr() % 16
    cases = [(_rnd(g, (8, K), torch.bfloat16, dev), wq), (_rnd(g, (300, K), torch.bfloat16, dev), wq),
             (hu, wq16), (_rnd(g, (8, K), torch.float32, dev), wq16)]
    for h, w in cases:
        before = (W4_GEMM.launches, W4_GEMM_STREAM.launches + W4_GEMM_MMA.launches)
        _check(gemm_w4(h, w), gemm_w4_plain(h, w), h.dtype)
        assert (W4_GEMM.launches, W4_GEMM_STREAM.launches + W4_GEMM_MMA.launches) == (
            before[0] + 1, before[1])
        for route in ("stream", "mma"):
            with pytest.raises(Exception):
                gemm_w4(h, w, route=route)
    for M in (8, 300):
        h = _rnd(g, (M, K), torch.bfloat16, dev)
        before = W4_GEMM.launches
        _check(gemm_w4(h, wq16, route="classic"), gemm_w4_plain(h, wq16), torch.bfloat16)
        assert W4_GEMM.launches == before + 1


# ---------------------------------------------------------------------------
# The f32 simt routes: csrc/gemm.cu gemm_simt_kernel and csrc/packed_gemm.cu
# packed_simt_kernel on the FFMA skeleton of csrc/simt_gemm.cuh, each against
# its plain version and bit for bit against the classic FFMA kernel it
# replaces (one fp32 accumulator an output, summed in k order with fmaf in
# both), each asserting which route's counter moved
# ---------------------------------------------------------------------------

# (M, K, N, epilogue): contiguous dimensions multiples of 4 (the route's
# 16-byte vectors) in every transposition, none a multiple of 16 or 128 but
# the small corner's K; K 1028 walks 65 slabs with a ragged last one
SIMT_SHAPES = [(300, 68, 136, "gelu"), (132, 1028, 260, "relu"), (516, 36, 388, "sigmoid"),
               (4, 20, 12, "tanh"), (260, 100, 132, None)]


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("shape", SIMT_SHAPES, ids=lambda s: "x".join(map(str, s[:3])))
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_simt(dev, ta, tb, shape, with_c, out_dtype):
    """route="simt" with a bias and each epilogue, alpha and beta * C, to f32
    and bf16: the classic kernel's bits, the plain version's values; only
    its counter moves."""
    from laser_tpu_torch.ops.gemm.kernel import GEMM, GEMM_SIMT, gemm_fused, gemm_plain

    M, K, N, epilogue = shape
    g = _gen(dev, 96)
    a = _rnd(g, (K, M) if ta else (M, K), torch.float32, dev)
    b = _rnd(g, (N, K) if tb else (K, N), torch.float32, dev, std=K ** -0.5)
    kw = dict(bias=_rnd(g, (N,), torch.float32, dev), epilogue=epilogue, transpose_a=ta,
              transpose_b=tb, out_dtype=out_dtype)
    if with_c:
        kw.update(alpha=0.75, beta=-1.5, c=_rnd(g, (M, N), torch.float32, dev))
    before = (GEMM_SIMT.launches, GEMM.launches)
    got = gemm_fused(a, b, route="simt", **kw)
    assert (GEMM_SIMT.launches, GEMM.launches) == (before[0] + 1, before[1])
    classic = gemm_fused(a, b, route="classic", **kw)
    assert GEMM.launches == before[1] + 1
    torch.cuda.synchronize()
    assert torch.equal(got, classic)
    _check(got, gemm_plain(a, b, **kw), out_dtype)


def test_gemm_batched_simt(dev):
    """f32 batched takes the simt route (blockIdx.z), counted on gemm_simt:
    the classic batched kernel's bits."""
    from laser_tpu_torch.ops.gemm.batched import (GEMM_BATCHED, _gemm_batched_cuda,
                                                  gemm_batched, gemm_batched_plain)
    from laser_tpu_torch.ops.gemm.kernel import GEMM_SIMT

    g = _gen(dev, 97)
    a, b = _rnd(g, (3, 140, 36), torch.float32, dev), _rnd(g, (3, 36, 44), torch.float32, dev)
    before = (GEMM_SIMT.launches, GEMM_BATCHED.launches)
    got = gemm_batched(a, b)
    assert (GEMM_SIMT.launches, GEMM_BATCHED.launches) == (before[0] + 1, before[1])
    classic = _gemm_batched_cuda(a, b, torch.float32, route="classic")
    assert GEMM_BATCHED.launches == before[1] + 1
    torch.cuda.synchronize()
    assert torch.equal(got, classic)
    _check(got, gemm_batched_plain(a, b, torch.float32), torch.float32)


def test_gemm_f32_routes_by_shape(dev):
    """The library's f32 routes: M 65 and above takes simt, M 64 and below
    split-K, a transposed operand at M 8 simt (split-K does not take it), an
    operand off 16 bytes or a contiguous dimension off a multiple of 4 the
    classic kernel. route="simt" refuses bf16 and those two, and route=
    "splitk" a transposed operand."""
    from laser_tpu_torch.ops.gemm.kernel import (GEMM, GEMM_SIMT, GEMM_SPLITK, gemm_fused,
                                                 gemm_plain)

    g = _gen(dev, 98)
    K, N = 256, 200
    w = _rnd(g, (K, N), torch.float32, dev, std=K ** -0.5)

    def counts():
        return GEMM.launches, GEMM_SIMT.launches, GEMM_SPLITK.launches

    for M, taken in ((65, 1), (300, 1), (64, 2), (1, 2)):
        x = _rnd(g, (M, K), torch.float32, dev)
        before = counts()
        _check(gemm_fused(x, w), gemm_plain(x, w), torch.float32)
        assert counts()[taken] == before[taken] + 1 and sum(counts()) == sum(before) + 1, M
    x = _rnd(g, (8, K), torch.float32, dev)
    xt = x.t().contiguous()
    xu = _rnd(g, (8 * K + 1,), torch.float32, dev)[1:].view(8, K)
    x70, w70 = _rnd(g, (300, 70), torch.float32, dev), _rnd(g, (70, N), torch.float32, dev)
    assert xu.data_ptr() % 16
    cases = [((xt, w), dict(transpose_a=True), gemm_plain(x, w), 1),
             ((xu, w), {}, gemm_plain(xu, w), 0),
             ((x70, w70), {}, gemm_plain(x70, w70), 0)]
    for args, kw, want, taken in cases:
        before = counts()
        _check(gemm_fused(*args, **kw), want, torch.float32)
        assert counts()[taken] == before[taken] + 1 and sum(counts()) == sum(before) + 1, taken
        if taken == 0:
            with pytest.raises(Exception):
                gemm_fused(*args, route="simt", **kw)
    with pytest.raises(Exception):
        gemm_fused(xt, w, transpose_a=True, route="splitk")
    with pytest.raises(Exception):
        gemm_fused(x.bfloat16(), w.bfloat16(), route="simt")


@pytest.mark.parametrize("plan", ["planned", (128, 128, 16), (256, 128, 64), (128, 256, 32),
                                  (128, 128, 48)])
@pytest.mark.parametrize("shape", [(100, 120, 90), (130, 257, 200), (384, 256, 320),
                                   (1, 1, 1)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_packed_simt(dev, plan, shape, out_dtype):
    """The simt route over f32 packed blocks, with and without beta * C, at
    M, N, K off the plan (zero padding inert, the epilogue masked): the
    classic kernels' bits, the plain version's values; only its counter
    moves."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.gemm import GemmTiles, gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import gemm_packed_plain, simt_route

    M, N, K = shape
    g = _gen(dev, 99)
    a, b = _rnd(g, (M, K), torch.float32, dev), _rnd(g, (K, N), torch.float32, dev,
                                                       std=K ** -0.5)
    c = _rnd(g, (M, N), torch.float32, dev)
    tiles = None if plan == "planned" else GemmTiles(*plan, vmem_limit_bytes=0)
    pa, pb = gemm_prepack_a(a, tiles=tiles), gemm_prepack_b(b, tiles=tiles)
    assert simt_route(torch.float32, pa.block[0], pb.block[1], pa.block[1])
    for cc in (None, c):
        registry.reset_counts()
        got = gemm_packed(0.5, pa, pb, -1.5, cc, out_dtype=out_dtype)
        counts = registry.counts()
        assert counts["gemm_packed_simt"]["launches"] == 1
        assert sum(v["launches"] for v in counts.values()) == 1
        classic = gemm_packed(0.5, pa, pb, -1.5, cc, out_dtype=out_dtype, route="classic")
        assert registry.counts()["gemm_packed"]["launches"] == 1
        torch.cuda.synchronize()
        assert torch.equal(got, classic)
        _check(got, gemm_packed_plain(0.5, pa, pb, -1.5, cc, torch.float32, torch.float32,
                                      out_dtype), out_dtype)


def test_gemm_packed_simt_refuses_what_it_does_not_take(dev):
    """route="simt" raises on the odd plan (the gather route's), on bf16 and
    on an unknown name; the odd plan still runs on the classic kernels."""
    from laser_tpu_torch.ops.gemm import GemmTiles, gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.prepacked import GEMM_PACKED, gemm_packed_plain

    g = _gen(dev, 100)
    a, b = _rnd(g, (100, 90), torch.float32, dev), _rnd(g, (90, 120), torch.float32, dev)
    odd = GemmTiles(48, 80, 40, vmem_limit_bytes=0)
    po, qo = gemm_prepack_a(a, tiles=odd), gemm_prepack_b(b, tiles=odd)
    before = GEMM_PACKED.launches
    _check(gemm_packed(1.0, po, qo), gemm_packed_plain(1.0, po, qo, 0.0, None, torch.float32,
                                                       torch.float32, torch.float32),
           torch.float32)
    assert GEMM_PACKED.launches == before + 1
    with pytest.raises(ValueError, match="simt"):
        gemm_packed(1.0, po, qo, route="simt")
    with pytest.raises(ValueError, match="simt"):
        gemm_packed(1.0, gemm_prepack_a(a.bfloat16()), gemm_prepack_b(b.bfloat16()),
                    route="simt")
