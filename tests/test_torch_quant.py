"""The port's quantisation against laser_tpu's, same numpy inputs: int4
packing and group scales, the weight-only int4 GEMM, per-column int8
weights, int8 KV rows and paged attention over int8 pages.

Tolerances: packed bytes, int8 values and scales identical; ``gemm_w4``
within 1e-5 of max |reference| in f32; int8 ``paged_attention`` within 1e-5
of laser_tpu's kernel at ``paged_quant_mode="base"`` (f32 products; the
bf16 limb tiers are the TPU's and are not ported) and of laser_tpu's
dense-gather oracle on the dequantized pools.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laser_tpu.config as jconfig
from laser_tpu.ops.gemm import int4_kernel as jint4
from laser_tpu.ops.paged_attention import paged_attention as jpaged
from laser_tpu.ops.paged_attention import paged_attention_reference as jpaged_reference
from laser_tpu.ops.paged_attention import quantize_kv as jquantize_kv
from laser_tpu.serving.engine import _quantize_weight as jquantize_weight
from laser_tpu_torch.convert import params_from_numpy
from laser_tpu_torch.ops.gemm import int4_kernel
from laser_tpu_torch.ops.paged_attention import (PAGED, paged_attention,
                                                 paged_attention_reference, quantize_kv)
from laser_tpu_torch.serving.engine import _quantize_weight


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("K,N,group", [(64, 40, 16), (192, 33, 64)])
def test_int4_pack_and_quantize_identical(K, N, group):
    rng = np.random.RandomState(60)
    w = rng.randn(K, N).astype(np.float32)
    w[:group, 0] = 0.0  # an all-zero group takes the unit scale
    want = jint4.quantize_int4(jnp.asarray(w), group=group)
    got = int4_kernel.quantize_int4(torch.from_numpy(w), group=group)
    assert got["q4"].dtype == torch.int8 and got["s4"].dtype == torch.float32
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    np.testing.assert_array_equal(got["s4"].numpy(), np.asarray(want["s4"]))
    np.testing.assert_array_equal(int4_kernel.unpack_int4(got["q4"]).numpy(),
                                  np.asarray(jint4.unpack_int4(want["q4"])))
    np.testing.assert_array_equal(int4_kernel.dequantize_int4(got).numpy(),
                                  np.asarray(jint4.dequantize_int4(want)))
    q = rng.randint(-8, 8, (K, N)).astype(np.int8)  # every nibble value packs back
    np.testing.assert_array_equal(int4_kernel.pack_int4(torch.from_numpy(q)).numpy(),
                                  np.asarray(jint4.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(
        int4_kernel.unpack_int4(int4_kernel.pack_int4(torch.from_numpy(q))).numpy(), q)


@pytest.mark.parametrize("M,K,N,group", [(1, 64, 40, 16), (9, 192, 33, 64)])
def test_gemm_w4_f32(M, K, N, group):
    rng = np.random.RandomState(61)
    h = rng.randn(M, K).astype(np.float32)
    wq = jint4.quantize_int4(jnp.asarray(rng.randn(K, N).astype(np.float32)), group=group)
    want = np.asarray(jint4.gemm_w4(jnp.asarray(h), wq))
    twq = params_from_numpy({k: np.asarray(v) for k, v in wq.items()}, device="cpu")
    before = int4_kernel.W4_GEMM.plain_calls
    got = int4_kernel.gemm_w4(torch.from_numpy(h), twq)
    assert int4_kernel.W4_GEMM.plain_calls == before + 1
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= 1e-5


def test_gemm_w4_rejects_a_bad_layout():
    h = torch.zeros(2, 64)
    wq = int4_kernel.quantize_int4(torch.randn(64, 8), group=16)
    with pytest.raises(ValueError):
        int4_kernel.gemm_w4(torch.zeros(2, 32), wq)
    with pytest.raises(TypeError):
        int4_kernel.gemm_w4(h, {"q4": wq["q4"], "s4": wq["s4"].double()})
    with pytest.raises(ValueError):
        int4_kernel.quantize_int4(torch.randn(64, 8), group=24)


def test_int8_weight_and_kv_quantisation_identical():
    rng = np.random.RandomState(62)
    w = rng.randn(48, 20).astype(np.float32)
    w[:, 3] = 0.0
    want = jquantize_weight(jnp.asarray(w))
    got = _quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    x = rng.randn(3, 4, 16, 32).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 5] *= 1e-3
    wq, ws = jquantize_kv(jnp.asarray(x))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
def test_int8_paged_attention(Hq, Hkv):
    rng = np.random.RandomState(63)
    S, hd, ps, mp = 4, 32, 16, 4
    P = S * mp + 1
    q = rng.randn(S, Hq, hd).astype(np.float32)
    kq, ks = jquantize_kv(jnp.asarray(rng.randn(P, Hkv, ps, hd).astype(np.float32)))
    vq, vs = jquantize_kv(jnp.asarray(rng.randn(P, Hkv, ps, hd).astype(np.float32)))
    kq, ks, vq, vs = map(np.array, (kq, ks, vq, vs))  # writable copies
    tables = rng.permutation(P)[:S * mp].reshape(S, mp).astype(np.int32)
    lengths = np.array([0, 1, ps + 3, mp * ps], np.int32)
    old = jconfig.get_config().paged_quant_mode
    try:
        jconfig.set_config(paged_quant_mode="base")
        want = np.asarray(jpaged(*map(jnp.asarray, (q, kq, vq, tables, lengths)),
                                 k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    finally:
        jconfig.set_config(paged_quant_mode=old)
    oracle = np.asarray(jpaged_reference(
        jnp.asarray(q), jnp.asarray(kq * ks[..., None]), jnp.asarray(vq * vs[..., None]),
        jnp.asarray(tables), jnp.asarray(lengths)))
    args = [torch.from_numpy(a) for a in (q, kq, vq, tables, lengths)]
    kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    before = PAGED.plain_calls
    got = paged_attention(*args, **kw).numpy()
    assert PAGED.plain_calls == before + 1
    assert _rel(got, want) <= 1e-5 and _rel(got, oracle) <= 1e-5
    assert np.all(got[0] == 0.0)  # length 0: zeros
    np.testing.assert_array_equal(paged_attention_reference(*args, **kw).numpy(), got)
    with pytest.raises(ValueError):  # int8 pools need their scales
        paged_attention(*args)
