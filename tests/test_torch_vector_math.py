"""laser_tpu_torch's exp / log / tanh / sigmoid (the plain route, on the
CPU: laser_tpu's polynomial cores written in torch) against laser_tpu's
``for_each`` kernels in interpret mode and against float64 numpy, on the
same inputs from a seed.

Tolerances: the accurate tier within 1e-6 of float64 (relative, over
|f| > 1; absolute below), the bar of laser_tpu's own vector-math tests, and
within 1e-6 of laser_tpu (the same polynomial; XLA on the CPU may contract
a multiply-add that torch rounds twice); bf16 one bf16 rounding. Specials
as laser_tpu defines them: +-inf clamp to exp(+-88), NaN propagates, log
of 0 is -inf and of a negative NaN.
"""

import importlib.util
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import laser_tpu as lt
from laser_tpu_torch import config, registry
from laser_tpu_torch.ops import vector_math as vm

NAMES = ["exp", "log", "tanh", "sigmoid"]
SPECIALS = np.array([0.0, -0.0, 88.0, -88.0, 87.9, -87.3, 1e-30, -1e-30, 20.0, -20.0,
                     np.inf, -np.inf, np.nan], np.float32)


def _oracle(name, x):
    x = x.astype(np.float64)
    with np.errstate(all="ignore"):
        return {"exp": np.exp, "log": np.log, "tanh": np.tanh,
                "sigmoid": lambda v: 1 / (1 + np.exp(-v))}[name](x)


def _inputs(name, seed, n=2000):
    x = np.random.RandomState(seed).uniform(-87.0, 88.0, n).astype(np.float32)
    if name == "log":
        x = np.concatenate([np.abs(x) * np.float32(1e3), np.abs(x) * np.float32(1e-30),
                            np.float32([-1.0, -5.0])])
    return np.concatenate([x, SPECIALS])


@pytest.fixture(scope="module")
def ref():
    out = {}
    for i, name in enumerate(NAMES):
        x = _inputs(name, i)
        xb = x.astype(ml_dtypes.bfloat16)
        out[name] = (x, np.asarray(getattr(lt, name)(x)),
                     xb, np.asarray(getattr(lt, name)(xb)).astype(np.float32))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_accurate_tier_vs_laser_tpu_and_float64(ref, name):
    x, want, _, _ = ref[name]
    registry.reset_counts()
    got = getattr(vm, name)(torch.from_numpy(x), algorithm="accurate").numpy()
    assert registry.counts()["for_each"]["plain_calls"] == 1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, equal_nan=True)
    oracle = _oracle(name, x)
    fin = np.isfinite(x) & (x > -87.3) & np.isfinite(oracle)  # exp flushes below ln 2^-126
    err = np.abs(got[fin] - oracle[fin]) / np.maximum(np.abs(oracle[fin]), 1.0)
    assert err.max() <= 1e-6, err.max()


def test_specials_as_laser_tpu():
    x = torch.from_numpy(SPECIALS)
    e = vm.exp(x).numpy()
    assert e[10] == e[2] and np.isfinite(e[2])  # +inf clamps to 88
    assert e[11] == e[3] and np.isnan(e[12]) and e[0] == 1.0
    lg = vm.log(torch.tensor([0.0, -1.0, np.inf, np.nan, 1.0])).numpy()
    assert lg[0] == -np.inf and np.isnan(lg[1]) and lg[2] == np.inf and np.isnan(lg[3])
    assert lg[4] == 0.0
    t = vm.tanh(x).numpy()
    assert t[10] == 1.0 and t[11] == -1.0 and np.isnan(t[12]) and t[0] == 0.0
    s = vm.sigmoid(x).numpy()
    assert s[10] == 1.0 and s[11] == 0.0 and np.isnan(s[12]) and s[0] == 0.5


@pytest.mark.parametrize("name", NAMES)
def test_accurate_tier_bf16_vs_laser_tpu(ref, name):
    """bf16 in, bf16 out: exp and log cast once, tanh and sigmoid round
    every step to bf16 on both sides."""
    _, _, xb, want = ref[name]
    xt = torch.from_numpy(xb.astype(np.float32)).bfloat16()
    got = getattr(vm, name)(xt, algorithm="accurate")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7,
                               equal_nan=True)


@pytest.mark.parametrize("name", NAMES)
def test_fast_tier_is_torch_function_on_the_cpu(name):
    """The fast tier's plain version is torch's function (the kernel uses
    CUDA's intrinsics, held to it on the card); laser_tpu's fast tier is
    jnp's function: within 1e-6 of each other."""
    x = _inputs(name, 10 + NAMES.index(name), n=500)
    x = x[np.isfinite(x)]
    with config.config_override(vector_math_algorithm="fast"):
        got = getattr(vm, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(lt, name)(x, algorithm="fast"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, equal_nan=True)


def test_donate_and_unknown_tier():
    x = torch.linspace(-3, 3, 50)
    want = vm.exp(x.clone())
    out = vm.exp(x, donate=True)
    assert out.data_ptr() == x.data_ptr() and torch.equal(x, want)
    with pytest.raises(ValueError, match="unknown algorithm"):
        vm.exp(x, algorithm="lut")
    with pytest.raises(TypeError, match="float"):
        vm.exp(torch.arange(3))
    with pytest.raises(ValueError):
        config.set_config(vector_math_algorithm="lut")


def test_vector_math_body_is_one_node():
    """In a traced body each core is one call into csrc/vector_math.cuh,
    templated on the storage type where it rounds every step."""
    from laser_tpu_torch.ops.foreach import for_each_source

    x = torch.ones(8, dtype=torch.bfloat16)
    assert "ltt::vm::exp_acc(v0)" in for_each_source(vm.pick("exp", "accurate"), x.float())
    assert "ltt::vm::sigmoid_acc<__nv_bfloat16>(v0)" in for_each_source(vm.sigmoid_acc, x)
    assert "ltt::vm::tanh_fast(v0)" in for_each_source(vm.pick("tanh", "fast"), x)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("check,dtype", [("exact", torch.float32), ("exact", torch.bfloat16),
                                         ("rel", torch.float32), ("bf16", torch.bfloat16)])
def test_smoke_check_fails_an_exp_core_wrong_for_small_inputs(check, dtype):
    """chip_smoke.py's phase 13 holds exp over randn * 4 (values up to
    e^22) element by element. A core that is off by 2^-6 relative (two bf16
    ulps, 2^17 f32 ulps) for every |x| < 8 and right elsewhere must fail
    each elementwise check; the plain version itself passes."""
    smoke = _chip_smoke()
    x = (torch.randn(256, 256, generator=torch.Generator().manual_seed(0)) * 4).to(dtype)
    want = vm.exp(x, algorithm="accurate")  # the plain version, on the CPU
    bad = torch.where(x.abs() < 8, want * (1 + 2 ** -6), want).to(dtype)
    case = smoke.Prim(name="for_each", slot="exp", shape="256x256", run=None, plain=None,
                      nbytes=0, flops=0, check=check, dtype=dtype)
    assert smoke.prim_check(case, want.clone(), want) == 0.0
    with pytest.raises(SystemExit):
        smoke.prim_check(case, bad, want)
