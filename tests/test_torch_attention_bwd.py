"""laser_tpu_torch attention backward against laser_tpu's, same inputs.

``attention_trainable``'s gradients (the port: the stats forward and the
backward's plain version on CPU tensors) against ``jax.grad`` of laser_tpu's
``attention_trainable`` (its flash backward kernels in interpret mode).
Tolerance: max |port - laser_tpu| <= 1e-5 x max |laser_tpu| per gradient
in f32 (both recompute P from fp32 (m, l); they differ in summation order).
At S = 1 the one probability is 1, so ds = p (dp - rowsum(dO o)) and with it
dq and dk are zero up to rounding on both sides: those two are held against
max(max |laser_tpu|, 1) instead. The same bound holds for
``attention_with_stats``'s out, m and l. ``route=`` names a CUDA route of
the kernels (csrc/flash_attention_bwd.cu ``enum Route``); on CPU tensors
every route runs the plain version, so its results equal the reference's
bit for bit, and an unknown name raises.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops.attention import attention_trainable as jattention_trainable
from laser_tpu.ops.attention import attention_with_stats as jattention_with_stats
from laser_tpu_torch import registry
from laser_tpu_torch.ops.attention import attention_trainable, attention_with_stats
from laser_tpu_torch.ops import attention_bwd
from laser_tpu_torch.ops.attention_bwd import (flash_attention_bwd,
                                               flash_attention_bwd_reference)

REL = 1e-5


def _rel_err(got, want, floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), floor)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 37, 100])
@pytest.mark.parametrize("D", [64, 128])
def test_grads_vs_laser_tpu(causal, S, D):
    rng = np.random.RandomState(S * 1000 + D + causal)
    q, k, v, g = (rng.randn(1, 2, S, D).astype(np.float32) for _ in range(4))

    def f(q, k, v):
        return jnp.sum(jattention_trainable(q, k, v, causal=causal) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = attention_trainable(qt, kt, vt, causal=causal)
    (o * torch.from_numpy(g)).sum().backward()
    for name, got, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        floor = 1.0 if S == 1 and name in "qk" else 1e-30
        assert _rel_err(got, w, floor) <= REL, name


@pytest.mark.parametrize("causal", [True, False])
def test_stats_vs_laser_tpu(causal):
    rng = np.random.RandomState(30)
    q, k, v = (rng.randn(2, 3, 45, 64).astype(np.float32) for _ in range(3))
    want = jattention_with_stats(q, k, v, causal=causal)
    got = attention_with_stats(*map(torch.from_numpy, (q, k, v)), causal=causal)
    for name, a, b in zip(("out", "m", "l"), got, want):
        assert _rel_err(a, b) <= REL, name


def test_cpu_runs_the_plain_backward():
    rng = np.random.RandomState(31)
    q, k, v, do = (torch.from_numpy(rng.randn(3, 20, 32).astype(np.float32))
                   for _ in range(4))
    o, m, l = attention_with_stats(q, k, v, causal=True)
    before = registry.counts()["flash_attention_bwd_dq"]["plain_calls"]
    got = flash_attention_bwd(q, k, v, o, m, l, do, causal=True, scale=32 ** -0.5)
    want = flash_attention_bwd_reference(q, k, v, o, m, l, do, causal=True, scale=32 ** -0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert registry.counts()["flash_attention_bwd_dq"]["plain_calls"] == before + 2


def test_unported_options_raise():
    z = torch.zeros(1, 8, 64)
    s = torch.zeros(1, 8)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd(z, z, z, z, s, s, z, causal=True, scale=1.0, window=4)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd(z, z, z, z, s, s, z, causal=True, scale=1.0, dvec=s)
    with pytest.raises(NotImplementedError):
        attention_with_stats(z, z, z, causal=True, q_offset=8)
    with pytest.raises(NotImplementedError):
        attention_trainable(z.requires_grad_(True), z, z, causal=True, window=4)


def test_route_codes_match_the_launcher():
    text = (registry.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    body = re.search(r"enum Route \{([^}]*)\}", text).group(1)
    codes = {k.strip(): int(v) for k, v in (e.split("=") for e in body.split(","))}
    assert sorted(codes.values()) == sorted(attention_bwd.ROUTES.values())
    assert attention_bwd.ROUTES[None] == 0
    assert sorted(attention_bwd.ROUTE_KERNELS) == sorted(v for v in codes.values() if v)
    names = [k.name for pair in attention_bwd.ROUTE_KERNELS.values() for k in pair]
    assert len(set(names)) == 4 and all(n.startswith("flash_attention_bwd_") for n in names)


def test_routes_on_the_cpu_run_the_plain_version():
    rng = np.random.RandomState(32)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 9, 64).astype(np.float32)).bfloat16()
                   for _ in range(4))
    o, m, l = attention_with_stats(q, k, v, causal=True)
    want = flash_attention_bwd_reference(q, k, v, o, m, l, do, causal=True, scale=0.125)
    for route in attention_bwd.ROUTES:
        got = flash_attention_bwd(q, k, v, o, m, l, do, causal=True, scale=0.125, route=route)
        for a, b in zip(got, want):
            assert torch.equal(a, b), route
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, m, l, do, causal=True, scale=0.125, route="wgmma")
