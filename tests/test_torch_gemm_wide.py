"""laser_tpu_torch's f64 GEMM and limb kernel against laser_tpu's.

On the same seeded mixed-exponent inputs (randn * 2^[-30, 30), the
exponent spread of bench.py's f64 rows and tests/test_gemm_wide.py):

- ``f64_digits``: digit planes and scales bit-identical to laser_tpu's;
- ``gemm_limbs`` on the same digits (8 and 4 planes, a K tail, 3 x 5 planes
  into 6 buckets): bucket planes bit-identical to laser_tpu's kernel;
- ``gemm_f64`` (8 and 4 slices, alpha / beta / C with the tanh epilogue
  through ``gemm``, a transposed operand): within 2^-52 K rowmax(|a|)
  colmax(|b|) of laser_tpu's result, and within the bounds of laser_tpu's
  own test against NumPy f64 (2^-50 for 8 slices, 2^-24 for 4, 1e-9 for
  the epilogue path);
- zero rows and columns give exact zeros.

laser_tpu runs its Pallas limb kernel in interpret mode; f64 needs
``jax_enable_x64``, so its outputs come from one child process for the
file (a module-scoped fixture writing an .npz), as tests/test_gemm_wide.py
runs its x64 numerics.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from laser_tpu_torch.ops.gemm import gemm
from laser_tpu_torch.ops.gemm.f64_kernel import f64_digits, gemm_f64
from laser_tpu_torch.ops.gemm.limb_kernel import gemm_limbs, gemm_limbs_kmajor, max_k_for


def _inputs():
    rng = np.random.RandomState(0xF64)
    M, K, N = 17, 96, 11
    a = rng.randn(M, K) * np.exp2(rng.randint(-30, 30, (M, K)))
    b = rng.randn(K, N) * np.exp2(rng.randint(-30, 30, (K, N)))
    c = rng.randn(M, N)
    az, bz = a.copy(), b.copy()
    az[3, :] = 0.0
    bz[:, 4] = 0.0
    d35a = rng.randint(-128, 128, (3, 9, 70)).astype(np.int8)
    d35b = rng.randint(-128, 128, (5, 70, 6)).astype(np.int8)
    return dict(a=a, b=b, c=c, az=az, bz=bz, d35a=d35a, d35b=d35b)


X = _inputs()

_CHILD = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
import laser_tpu as lt
from laser_tpu.ops.gemm import f64_kernel, limb_kernel

x = dict(np.load(sys.argv[1]))
out = {}


def limbs(da, db, nb):
    # laser_tpu's gemm_limbs takes operands padded to Mosaic's int8 tiling
    na, M, K = da.shape
    nbp, _, N = db.shape
    Mp, Kp, Np = -(-M // 32) * 32, -(-K // 128) * 128, -(-N // 128) * 128
    pa = np.zeros((na, Mp, Kp), np.int8); pa[:, :M, :K] = da
    pb = np.zeros((nbp, Kp, Np), np.int8); pb[:, :K, :N] = db
    r = limb_kernel.gemm_limbs(jnp.asarray(pa), jnp.asarray(pb), nb, interpret=True)
    return np.asarray(r)[:, :M, :N]


for slices in (8, 4):
    da, sa = f64_kernel.f64_digits(jnp.asarray(x["a"]), 1, slices)
    db, sb = f64_kernel.f64_digits(jnp.asarray(x["b"]), 0, slices)
    out[f"da{slices}"], out[f"sa{slices}"] = np.asarray(da), np.asarray(sa)
    out[f"db{slices}"], out[f"sb{slices}"] = np.asarray(db), np.asarray(sb)
    out[f"buckets{slices}"] = limbs(np.asarray(da), np.asarray(db), slices)
    out[f"f64_{slices}"] = np.asarray(f64_kernel.gemm_f64(
        jnp.asarray(x["a"]), jnp.asarray(x["b"]), slices=slices, interpret=True))
out["buckets_3x5"] = limbs(x["d35a"], x["d35b"], 6)
out["epilogue"] = np.asarray(lt.gemm(jnp.asarray(x["a"]), jnp.asarray(x["b"]), alpha=1.5,
                                     beta=-0.5, c=jnp.asarray(x["c"]), epilogue="tanh"))
out["transposed"] = np.asarray(lt.gemm(jnp.asarray(x["a"].T.copy()), jnp.asarray(x["b"]),
                                       transpose_a=True))
out["zeros"] = np.asarray(f64_kernel.gemm_f64(jnp.asarray(x["az"]), jnp.asarray(x["bz"]),
                                              interpret=True))
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def laser(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemm_wide")
    np.savez(d / "in.npz", **X)
    r = subprocess.run([sys.executable, "-c", _CHILD, str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return np.load(d / "out.npz")


def _t(name):
    return torch.from_numpy(np.ascontiguousarray(X[name]))


def _scaled_err(got, want):
    """max |got - want| / (K rowmax(|a|) colmax(|b|))."""
    a, b = X["a"], X["b"]
    scale = np.abs(a).max(1)[:, None] * np.abs(b).max(0)[None, :]
    return (np.abs(np.asarray(got) - want) / (a.shape[1] * scale)).max()


def test_max_k_for_matches_laser_tpu():
    from laser_tpu.ops.gemm.limb_kernel import max_k_for as jmax_k_for

    for n, dm in ((8, 128), (4, 128), (8, 64), (4, 64)):
        assert max_k_for(n, dm) == jmax_k_for(n, dm)
    assert max_k_for(8) == 8192 and max_k_for(8, 64) == 32768


@pytest.mark.parametrize("slices", [8, 4])
def test_digits_and_scales_bit_identical(laser, slices):
    da, sa = f64_digits(_t("a"), 1, slices)
    db, sb = f64_digits(_t("b"), 0, slices)
    for got, name in ((da, "da"), (sa, "sa"), (db, "db"), (sb, "sb")):
        want = laser[f"{name}{slices}"]
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["8", "4", "3x5"])
def test_limb_buckets_bit_identical(laser, case):
    if case == "3x5":
        da, db, nb = torch.from_numpy(X["d35a"]), torch.from_numpy(X["d35b"]), 6
    else:
        s = int(case)
        da, db, nb = torch.from_numpy(laser[f"da{s}"]), torch.from_numpy(laser[f"db{s}"]), s
    got = gemm_limbs(da, db, nb)
    assert got.dtype == torch.int32
    want = laser["buckets_3x5" if case == "3x5" else f"buckets{nb}"]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slices", [8, 4])
def test_kmajor_digits_of_b_t_bit_identical(laser, slices):
    """B's digits split from ``b.t()`` (the K-major planes the port's f64
    GEMM makes): laser_tpu's digits of b transposed, its scales, bit for
    bit."""
    dbt, sbt = f64_digits(_t("b").t(), 1, slices)
    assert dbt.is_contiguous() and dbt.dtype == torch.int8
    np.testing.assert_array_equal(dbt.numpy(), laser[f"db{slices}"].transpose(0, 2, 1))
    np.testing.assert_array_equal(sbt.numpy(), laser[f"sb{slices}"])


@pytest.mark.parametrize("case", ["8", "4", "3x5"])
def test_limb_buckets_kmajor_bit_identical(laser, case):
    """``gemm_limbs_kmajor`` on the K-major B planes: laser_tpu's buckets."""
    if case == "3x5":
        da, db, nb = torch.from_numpy(X["d35a"]), torch.from_numpy(X["d35b"]), 6
    else:
        s = int(case)
        da, db, nb = torch.from_numpy(laser[f"da{s}"]), torch.from_numpy(laser[f"db{s}"]), s
    got = gemm_limbs_kmajor(da, db.transpose(1, 2).contiguous(), nb)
    want = laser["buckets_3x5" if case == "3x5" else f"buckets{nb}"]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slices,oracle_bound", [(8, 2.0 ** -50), (4, 2.0 ** -24)])
def test_gemm_f64_vs_laser_tpu_and_numpy(laser, slices, oracle_bound):
    got = gemm_f64(_t("a"), _t("b"), slices=slices).numpy()
    assert got.dtype == np.float64
    assert _scaled_err(got, laser[f"f64_{slices}"]) <= 2.0 ** -52
    assert _scaled_err(got, X["a"] @ X["b"]) < oracle_bound


def test_gemm_dispatch_epilogue_and_transpose(laser):
    got = gemm(_t("a"), _t("b"), alpha=1.5, beta=-0.5, c=_t("c"), epilogue="tanh").numpy()
    assert got.dtype == np.float64
    assert np.abs(got - laser["epilogue"]).max() <= 2.0 ** -52
    assert np.abs(got - np.tanh(1.5 * (X["a"] @ X["b"]) - 0.5 * X["c"])).max() < 1e-9
    got_t = gemm(torch.from_numpy(X["a"].T.copy()), _t("b"), transpose_a=True).numpy()
    assert _scaled_err(got_t, laser["transposed"]) <= 2.0 ** -52


def test_zero_rows_and_columns_exact(laser):
    got = gemm_f64(_t("az"), _t("bz")).numpy()
    assert np.all(got[3, :] == 0.0) and np.all(got[:, 4] == 0.0)
    assert np.all(laser["zeros"][3, :] == 0.0) and np.all(laser["zeros"][:, 4] == 0.0)
    assert _scaled_err(got, laser["zeros"]) <= 2.0 ** -52
