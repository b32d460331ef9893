"""laser_tpu_torch's paged window attention (the speculative verify) against
laser_tpu's kernel in interpret mode, same numpy inputs: MHA and GQA, W 1, 3
and 5, lengths 0, exactly W, across a page and past the table, float and
int8 pools. Also: chip_smoke.py's check of the CUDA kernel, at its shapes,
fails a kernel that drops the keys after a slot's first page.

Tolerance: max |port - laser_tpu| <= 2e-5 of max |laser_tpu| in f32 (the
two sum in different orders); int8 pools at laser_tpu's
``paged_quant_mode="base"`` (f32 products), as tests/test_torch_quant.py.
"""

import importlib.util
import sys
from pathlib import Path


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laser_tpu.config as jconfig
from laser_tpu.ops.paged_attention import paged_window_attention as jwindow
from laser_tpu.ops.paged_attention import quantize_kv as jquantize_kv
from laser_tpu_torch.ops.paged_attention import (PAGED_WINDOW, paged_attention,
                                                 paged_window_attention,
                                                 paged_window_attention_reference)

TOL = 2e-5
PS, MP, HD = 16, 4, 32


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _case(seed, W, Hq, Hkv, quant=False):
    """Five slots: inactive, exactly W keys, a window across a page
    boundary, a full table, and a window two positions past the table (as
    the engine's last verify windows of a full slot: those rows attend
    every key the table holds)."""
    rng = np.random.RandomState(seed)
    S = 5
    P = S * MP + 1
    q = rng.randn(S, W, Hq, HD).astype(np.float32)
    kp = rng.randn(P, Hkv, PS, HD).astype(np.float32)
    vp = rng.randn(P, Hkv, PS, HD).astype(np.float32)
    tables = rng.permutation(P)[:S * MP].reshape(S, MP).astype(np.int32)
    lengths = np.array([0, W, PS + W // 2 + 1, MP * PS, MP * PS + 2], np.int32)
    scales = {}
    if quant:
        kp, ks = map(np.array, jquantize_kv(jnp.asarray(kp)))
        vp, vs = map(np.array, jquantize_kv(jnp.asarray(vp)))
        scales = dict(k_scale=ks, v_scale=vs)
    return (q, kp, vp, tables, lengths), scales


def _jax(args, scales):
    old = jconfig.get_config().paged_quant_mode
    try:
        jconfig.set_config(paged_quant_mode="base")
        return np.asarray(jwindow(*map(jnp.asarray, args),
                                  **{k: jnp.asarray(v) for k, v in scales.items()}))
    finally:
        jconfig.set_config(paged_quant_mode=old)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("W", [1, 3, 5])
def test_matches_laser_tpu(W, Hq, Hkv, quant):
    args, scales = _case(70 + W, W, Hq, Hkv, quant)
    want = _jax(args, scales)
    targs = [torch.from_numpy(a) for a in args]
    tscales = {k: torch.from_numpy(v) for k, v in scales.items()}
    before = PAGED_WINDOW.plain_calls
    got = paged_window_attention(*targs, **tscales).numpy()
    assert PAGED_WINDOW.plain_calls == before + 1
    assert got.shape == want.shape and _rel(got, want) <= TOL
    assert np.all(got[0] == 0.0)  # length 0: zeros
    np.testing.assert_array_equal(
        paged_window_attention_reference(*targs, **tscales).numpy(), got)


def test_one_query_is_paged_attention():
    """W = 1 is the decode kernel's function."""
    (q, kp, vp, tables, lengths), _ = _case(80, 1, 8, 2)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    got = paged_window_attention(*t)
    want = paged_attention(t[0][:, 0], *t[1:])
    assert _rel(got[:, 0].numpy(), want.numpy()) <= TOL


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def test_smoke_check_fails_a_kernel_that_drops_later_keys():
    """chip_smoke.py holds the bf16 window kernel to REL_BOUND row by row
    at run S1's shape (lengths 5 .. 1026 over 16 pages of 64). Two broken
    kernels, made from the plain version: one that zeroes the values past
    a slot's first 32 keys, one that reads only its first page. Each must
    miss the bound by more than ten times."""
    smoke = _chip_smoke()
    bound = smoke.REL_BOUND[torch.bfloat16]
    g = torch.Generator().manual_seed(0)
    S, W, H, hd, ps, pages = 8, smoke.SPEC_GAMMA + 1, 2, 128, 64, 16
    P = S * pages + 1
    q = torch.randn(S, W, H, hd, generator=g)
    kp, vp = torch.randn(P, H, ps, hd, generator=g), torch.randn(P, H, ps, hd, generator=g)
    tables = torch.randperm(P - 1, generator=g)[:S * pages].reshape(S, pages).int()
    lengths = torch.linspace(W, pages * ps + 2, S).int()
    want = paged_window_attention_reference(q, kp, vp, tables, lengths)
    vz = vp.clone()
    vz[tables[:, 1:].long()] = 0
    vz[tables[:, 0].long(), :, 32:] = 0
    broken = {"zeroed": paged_window_attention_reference(q, kp, vz, tables, lengths),
              "first page": paged_window_attention_reference(q, kp, vp, tables[:, :1].contiguous(),
                                                             lengths)}
    assert smoke.rel_error(want, want, per_row=True)[1] == 0.0
    for name, got in broken.items():
        assert smoke.rel_error(got, want, per_row=True)[1] > 10 * bound, name


def test_rejects_what_the_kernel_does_not_take():
    (q, kp, vp, tables, lengths), _ = _case(81, 3, 4, 4)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    with pytest.raises(NotImplementedError):  # sliding window: not ported
        paged_window_attention(*t, window=8)
    with pytest.raises(NotImplementedError):  # W x group past 64 rows
        paged_window_attention(t[0].repeat(1, 22, 1, 1), *t[1:])
    with pytest.raises(ValueError):  # int8 pools need their scales
        paged_window_attention(t[0], t[1].to(torch.int8), t[2].to(torch.int8), *t[3:])
    with pytest.raises(ValueError):  # a decode-shaped q
        paged_window_attention(t[0][:, 0], *t[1:])
