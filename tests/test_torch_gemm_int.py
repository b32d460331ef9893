"""laser_tpu_torch's integer GEMMs against laser_tpu's and an exact oracle.

int8 (-> int32), int32, uint32, int64 and uint64 through ``gemm``,
``gemm_int32``, ``gemm_int64`` and ``gemm_strided``, on the same seeded
inputs: the port (its plain versions, CPU tensors) must equal laser_tpu
(Pallas kernels in interpret mode, or its XLA route where laser_tpu takes
it) and an object-integer oracle reduced mod 2^32 or 2^64, bit for bit.
Covered: INT_MIN/MAX extremes, K tails (K = 1, 37, 100), int64 across its
8192 K-chunk (K = 8193), alpha, beta and C, transposed operands, the int8
epilogue (bias, relu, alpha = 0.5 cast to 0) and ``gemm_strided`` over
row-major, column-major and padded-row buffers.

int64 needs ``jax_enable_x64``, so laser_tpu's outputs come from one child
process for the whole file (a module-scoped fixture writing an .npz), as
tests/test_gemm_wide.py runs its x64 numerics; the flag never reaches the
rest of the suite.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from laser_tpu_torch.ops.gemm import gemm, gemm_int32, gemm_strided
from laser_tpu_torch.ops.gemm import int32_kernel, int64_kernel

I32 = (-2**31, 2**31 - 1)
I64 = (-2**63, 2**63 - 1)


def _rand(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.randint(info.min, info.max, shape, dtype=dtype)


def _extremes(rng, shape, dtype):
    info = np.iinfo(dtype)
    pool = np.array([info.min, info.max, -1, 0, 1, info.min + 1, info.max - 1], dtype)
    return pool[rng.randint(0, len(pool), shape)]


def _cases():
    """name -> (function, inputs, scalar kwargs); the inputs a, b and
    optional c, bias as numpy arrays."""
    rng = np.random.RandomState(20260817)
    i8, i32, i64 = np.int8, np.int32, np.int64
    # shapes shared within a dtype, so laser_tpu's interpret-mode builds are
    # reused: int8 (13, 37, 9), int32 (5, 100, 7), int64 (13, 31, 9)
    r8 = lambda *s: _rand(rng, s, i8)  # noqa: E731
    r32 = lambda *s: _rand(rng, s, i32)  # noqa: E731
    r64 = lambda *s: _rand(rng, s, i64)  # noqa: E731
    u32 = lambda *s: _rand(rng, s, np.uint32)  # noqa: E731
    cases = {
        "i8_random": ("gemm", dict(a=r8(13, 37), b=r8(37, 9)), {}),
        "i8_extremes": ("gemm", dict(a=_extremes(rng, (13, 100), i8),
                                     b=_extremes(rng, (100, 9), i8)), {}),
        "i8_k1": ("gemm", dict(a=r8(13, 1), b=r8(1, 9)), {}),
        "i8_trans_a": ("gemm", dict(a=r8(37, 13), b=r8(37, 9)), dict(transpose_a=True)),
        "i8_trans_b": ("gemm", dict(a=r8(13, 37), b=r8(9, 37)), dict(transpose_b=True)),
        "i8_trans_ab": ("gemm", dict(a=r8(37, 13), b=r8(9, 37)),
                        dict(transpose_a=True, transpose_b=True)),
        "i8_fused_wraps": ("gemm", dict(a=r8(13, 37), b=r8(37, 9), c=r32(13, 9), bias=r32(9)),
                           dict(alpha=3, beta=-2, epilogue="relu")),
        "i8_alpha_half": ("gemm", dict(a=r8(13, 37), b=r8(37, 9), c=r32(13, 9)),
                          dict(alpha=0.5, beta=1.5)),
        "i8_out_f32": ("gemm", dict(a=r8(13, 37), b=r8(37, 9)), dict(out_dtype="float32")),
        "i32_random": ("gemm", dict(a=r32(5, 100), b=r32(100, 7)), {}),
        "i32_extremes": ("gemm", dict(a=_extremes(rng, (5, 100), i32),
                                      b=_extremes(rng, (100, 7), i32)), {}),
        "i32_k1": ("gemm", dict(a=r32(5, 1), b=r32(1, 7)), {}),
        "i32_abc": ("gemm", dict(a=r32(5, 100), b=r32(100, 7), c=r32(5, 7)),
                    dict(alpha=-7, beta=3)),
        "i32_trans": ("gemm", dict(a=r32(100, 5), b=r32(7, 100)),
                      dict(transpose_a=True, transpose_b=True)),
        "i32_kernel_abc": ("gemm_int32", dict(a=_extremes(rng, (5, 100), i32), b=r32(100, 7),
                                              c=_extremes(rng, (5, 7), i32)),
                           dict(alpha=I32[0], beta=I32[1])),
        "u32_gemm": ("gemm", dict(a=u32(5, 100), b=u32(100, 7)), {}),
        "u32_gemm_int32": ("gemm_int32", dict(a=u32(5, 100), b=u32(100, 7), c=u32(5, 7)),
                           dict(alpha=5, beta=2)),
        "i32_acc_int64": ("gemm", dict(a=r32(5, 100), b=r32(100, 7)), dict(acc_dtype="int64")),
        "i32_bias_relu": ("gemm", dict(a=r32(5, 100), b=r32(100, 7), bias=r32(7)),
                          dict(epilogue="relu")),
        "i64_random": ("gemm", dict(a=r64(13, 31), b=r64(31, 9)), {}),
        "i64_extremes": ("gemm", dict(a=_extremes(rng, (13, 31), i64),
                                      b=_extremes(rng, (31, 9), i64)), {}),
        "i64_abc": ("gemm", dict(a=r64(13, 31), b=r64(31, 9), c=r64(13, 9)),
                    dict(alpha=3, beta=-5)),
        "i64_k_chunk": ("gemm", dict(a=r64(4, 8193), b=r64(8193, 3)), {}),
        "i64_trans": ("gemm", dict(a=r64(31, 13), b=r64(9, 31)),
                      dict(transpose_a=True, transpose_b=True)),
        "u64_gemm": ("gemm", dict(a=_rand(rng, (13, 31), np.uint64),
                                  b=_rand(rng, (31, 9), np.uint64)), {}),
    }
    # gemm_strided over flat buffers: (M, N, K) = (6, 5, 11)
    M, N, K = 6, 5, 11
    a = _rand(rng, (M, K), i32)
    b = _rand(rng, (K, N), i32)
    c = _rand(rng, (M, N), i32)
    pad_a = np.zeros((M, K + 3), i32)
    pad_a[:, :K] = a
    pad_c = np.zeros((M, N + 2), i32)
    pad_c[:, :N] = c
    cases["strided_row_major"] = ("gemm_strided", dict(a=a.ravel(), b=b.ravel()),
                                  dict(M=M, N=N, K=K, rsA=K, csA=1, rsB=N, csB=1, alpha=2,
                                       beta=0))
    cases["strided_col_major"] = ("gemm_strided", dict(a=a.T.ravel(), b=b.T.ravel(),
                                                       c=c.ravel()),
                                  dict(M=M, N=N, K=K, rsA=1, csA=M, rsB=1, csB=K, alpha=1,
                                       beta=-3, rsC=N, csC=1))
    cases["strided_padded_rows"] = ("gemm_strided", dict(a=pad_a.ravel(), b=b.T.ravel(),
                                                         c=pad_c.ravel()),
                                    dict(M=M, N=N, K=K, rsA=K + 3, csA=1, rsB=1, csB=K,
                                         alpha=-1, beta=4, rsC=N + 2, csC=1))
    return cases


CASES = _cases()

_CHILD = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
import laser_tpu as lt
from laser_tpu.ops.gemm import int32_kernel

spec = json.loads(open(sys.argv[1]).read())
arrays = np.load(sys.argv[2])
out = {}
for name, (fn, keys, kw) in spec.items():
    x = {k: arrays[f"{name}.{k}"] for k in keys}
    if "out_dtype" in kw:
        kw["out_dtype"] = jnp.dtype(kw["out_dtype"])
    if "acc_dtype" in kw:
        kw["acc_dtype"] = jnp.dtype(kw["acc_dtype"])
    if fn == "gemm":
        r = lt.gemm(x["a"], x["b"], c=x.get("c"), bias=x.get("bias"), **kw)
    elif fn == "gemm_int32":
        r = int32_kernel.gemm_int32(jnp.asarray(x["a"]), jnp.asarray(x["b"]),
                                    c=None if "c" not in x else jnp.asarray(x["c"]),
                                    interpret=True, **kw)
    else:
        r = lt.gemm_strided(kw["M"], kw["N"], kw["K"], kw["alpha"], x["a"], kw["rsA"],
                            kw["csA"], x["b"], kw["rsB"], kw["csB"], kw["beta"], x.get("c"),
                            kw.get("rsC", 0), kw.get("csC", 0))
    out[name] = np.asarray(r)
np.savez(sys.argv[3], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def laser(tmp_path_factory):
    """laser_tpu's output of every case, computed in one x64 child process."""
    d = tmp_path_factory.mktemp("gemm_int")
    spec = {name: (fn, sorted(x), kw) for name, (fn, x, kw) in CASES.items()}
    (d / "spec.json").write_text(json.dumps(spec))
    np.savez(d / "in.npz", **{f"{n}.{k}": v for n, (_, x, _) in CASES.items()
                              for k, v in x.items()})
    r = subprocess.run([sys.executable, "-c", _CHILD, str(d / "spec.json"), str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return np.load(d / "out.npz")


def _oracle(fn, x, kw):
    """Exact object-integer result, reduced mod 2^bits of the output type."""
    if fn == "gemm_strided":
        M, N, K = kw["M"], kw["N"], kw["K"]
        a = np.lib.stride_tricks.as_strided(x["a"], (M, K), (kw["rsA"] * 4, kw["csA"] * 4))
        b = np.lib.stride_tricks.as_strided(x["b"], (K, N), (kw["rsB"] * 4, kw["csB"] * 4))
        w = a.astype(object) @ b.astype(object) * int(kw["alpha"])
        if kw["beta"]:
            c = np.lib.stride_tricks.as_strided(x["c"], (M, N), (kw["rsC"] * 4, kw["csC"] * 4))
            w = w + int(kw["beta"]) * c.astype(object)
        out_t = np.int32
    else:
        a = x["a"].T if kw.get("transpose_a") else x["a"]
        b = x["b"].T if kw.get("transpose_b") else x["b"]
        w = a.astype(object) @ b.astype(object) * int(kw.get("alpha", 1))
        if "c" in x:
            w = w + int(kw.get("beta", 0)) * x["c"].astype(object)
        if "bias" in x:
            w = w + x["bias"].astype(object)[None, :]
        out_t = np.dtype(kw.get("out_dtype") or kw.get("acc_dtype") or
                         (np.int32 if x["a"].dtype == np.int8 else x["a"].dtype))
    if np.dtype(out_t).kind == "f":
        return w.astype(np.float64).astype(out_t)
    bits = np.dtype(out_t).itemsize * 8
    u = np.vectorize(lambda v: int(v) % 2**bits, otypes=[object])(w)
    r = u.astype(np.uint64 if bits == 64 else np.uint32).view(
        np.int64 if bits == 64 else np.int32)
    if kw.get("epilogue") == "relu":
        r = np.maximum(r, 0)
    return r.view(out_t) if np.dtype(out_t).kind == "u" else r.astype(out_t)


def _port(fn, x, kw):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    kw = dict(kw)
    for key in ("out_dtype", "acc_dtype"):
        if key in kw:
            kw[key] = getattr(torch, kw[key])
    if fn == "gemm":
        return gemm(t["a"], t["b"], c=t.get("c"), bias=t.get("bias"), **kw)
    if fn == "gemm_int32":
        return gemm_int32(t["a"], t["b"], c=t.get("c"), **kw)
    return gemm_strided(kw["M"], kw["N"], kw["K"], kw["alpha"], t["a"], kw["rsA"], kw["csA"],
                        t["b"], kw["rsB"], kw["csB"], kw["beta"], t.get("c"), kw.get("rsC", 0),
                        kw.get("csC", 0))


@pytest.mark.parametrize("name", list(CASES))
def test_bit_identical_to_laser_tpu_and_oracle(laser, name):
    fn, x, kw = CASES[name]
    got = _port(fn, x, kw).numpy()
    want = laser[name]
    oracle = _oracle(fn, x, kw)
    assert got.dtype == want.dtype == oracle.dtype, (got.dtype, want.dtype, oracle.dtype)
    assert got.shape == want.shape == oracle.shape
    np.testing.assert_array_equal(want, oracle)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,dtype,lims", [(4, torch.int32, I32), (8, torch.int64, I64)])
def test_limbs_reassemble_at_the_extremes(n, dtype, lims):
    """The overflow-free digit split gives digits in [-128, 127] that sum
    back to x mod 2^(8n), at INT_MIN and INT_MAX too."""
    vals = [lims[0], lims[0] + 1, -129, -128, -1, 0, 1, 127, 128, 255, 256, lims[1] - 1, lims[1]]
    x = torch.tensor(vals, dtype=dtype)
    limbs = (int32_kernel.int32_limbs if n == 4 else int64_kernel.int64_limbs)(x)
    assert limbs.dtype == torch.int8 and limbs.shape == (n, len(vals))
    for j, v in enumerate(vals):
        total = sum(int(limbs[i, j]) << (8 * i) for i in range(n))
        assert (total - v) % 2 ** (8 * n) == 0


def test_unsupported_integer_dtype_raises():
    with pytest.raises(NotImplementedError):
        gemm(torch.ones(2, 2, dtype=torch.int16), torch.ones(2, 2, dtype=torch.int16))


@pytest.mark.parametrize("n,np_dtype", [(4, np.int32), (8, np.int64)])
def test_kmajor_split_of_b_t_is_the_transposed_split(n, np_dtype):
    """The port splits ``b.t()`` so that B's limbs come K-major, (n, N, K),
    as the int8 wgmma route reads them: bit for bit the split of b,
    transposed, and contiguous."""
    rng = np.random.RandomState(21)
    b = torch.from_numpy(np.concatenate([_extremes(rng, (20, 23), np_dtype),
                                         _rand(rng, (17, 23), np_dtype)]))
    split = int32_kernel.int32_limbs if n == 4 else int64_kernel.int64_limbs
    kmajor = split(b.t())
    assert kmajor.shape == (n, 23, 37) and kmajor.is_contiguous()
    assert torch.equal(kmajor, split(b).transpose(1, 2))
