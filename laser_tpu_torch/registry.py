"""Kernel build cache, CUDA library builder and loader, launch counters.

Port of laser_tpu/registry.py. ``build_cache`` memoises a builder on its
static arguments, as there. The kernels themselves are CUDA C++ under
``laser_tpu_torch/csrc/``: on the first call that needs one (a wrapper given
a CUDA tensor), ``load_library`` compiles every ``csrc/*.cu`` with its own
``nvcc``, all at once, links the objects into one shared library with a
plain C interface and loads it through ctypes.
The library lands in ``build/laser_tpu_torch/<source hash>/`` beside the
package, so an edited source rebuilds and an unchanged one loads at once.
There is no fallback: without ``nvcc`` the first CUDA call raises
``KernelBuildError``. CPU tensors never build anything.

A second route builds *generated* sources: ``ops/codegen.py`` turns a
user's elementwise body into a short ``.cu`` text that includes a
hand-written template (``csrc/foreach.cuh``). ``load_generated`` compiles
each such text with its own ``nvcc`` (the same flags) into
``build/laser_tpu_torch/gen/<hash>/``, keyed on the text, every
``csrc/*.cuh`` and the flags, loads it through ctypes and memoises it in
the process; ``load_generated_many`` starts the builds of several texts
together. ``GEN_BUILDS`` counts the builds and their seconds. As for the
library, there is no fallback: a failed build raises ``KernelBuildError``
with nvcc's log.

Each kernel is described by a ``Kernel`` record holding two plain int
counters: ``launches`` (its wrapper adds one right after a successful
launch, and nowhere else) and ``plain_calls`` (its plain PyTorch version
adds one per call). ``reset_counts``/``counts`` let a run show which path
its work went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

logger = logging.getLogger("laser_tpu_torch")

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "laser_tpu_torch"
LIB_NAME = "liblaser_tpu_torch.so"
# the conventional toolkit location, searched after CUDA_HOME and PATH
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh (enum DType): the float types every
# kernel computes in, and beside them the int8 KV pages of the paged kernel
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POOL_DTYPE_CODES = {**DTYPE_CODES, torch.int8: 3}
# the GEMM kernel's input and output types: int8 inputs, int32 accumulator
GEMM_DTYPE_CODES = {**POOL_DTYPE_CODES, torch.int32: 4}

_P, _I, _F, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_D = ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)  # an out-parameter: the route a launcher took
_LLP = ctypes.POINTER(ctypes.c_longlong)  # an out-parameter: workspace bytes
# every pointer and the stream are c_void_p: undeclared, ctypes would pass
# them as 32-bit ints and cut the address
SIGNATURES = {
    # a, b, c, bias, out, workspace (or null), M, N, K, trans_a, trans_b,
    # alpha, beta (the int32 values for int8 inputs), epilogue, in_dtype,
    # out_dtype, route (0 picks, 1 WMMA/FFMA/int8, 2 wgmma (16-bit and int8), 3
    # split-K, 4 simt), route
    # taken (out), stream
    "ltt_gemm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _I, _I, _I, _I, _IP, _P),
    # a, b, M, N, K, trans_a, trans_b, in_dtype, route, workspace bytes (out)
    "ltt_gemm_workspace": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _LLP),
    # a, b, out, B, M, N, K, in_dtype, out_dtype, route, route taken, stream
    "ltt_gemm_batched": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _IP, _P),
    # a digits, b digits (K-major), out, nA, nB, n_buckets, M, N, K, route (0
    # picks, 1 classic, 2 wgmma), route taken (out), stream
    "ltt_gemm_limbs": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _IP, _P),
    # a limbs, b limbs (K-major), c (or null), out, M, N, K, alpha, beta,
    # route, route taken (out), stream
    "ltt_gemm_int32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _IP, _P),
    # x, q, scales, partials (or null), rows, cols, per_row, stochastic,
    # seed, dtype, stream
    "ltt_quantize_int8": (_P, _P, _P, _P, _I, _I, _I, _I, _I64, _I, _P),
    # x, gamma (or null), beta (or null), y, rows, cols, kind, eps, dtype,
    # gamma dtype, beta dtype, route (0 picks, 1 classic, 2 vec), route taken
    # (out), stream
    "ltt_norm": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _IP, _P),
    # q, k, v, o, m (or null), l (or null), BH, S, D, Hq, Hkv, causal, scale,
    # dtype, route (0 picks, 1 FFMA, 2 tensor cores), route taken (out), stream
    "ltt_flash_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _IP, _P),
    # q, k, v, dout, m, l, dvec, dq, BH, S, D, causal, scale, dtype, route
    # (0 picks, 1 FFMA, 2 tensor cores), route taken (out), stream
    "ltt_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                         _I, _I, _IP, _P),
    # q, k, v, dout, m, l, dvec, dk, dv, BH, S, D, causal, scale, dtype,
    # route, route taken (out), stream
    "ltt_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _F, _I, _I, _IP, _P),
    # x, targets, loss, lse, T, V, eps, dtype, stream
    "ltt_ce_fwd": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    # x, targets, loss, dxu, T, V, eps, dtype, stream
    "ltt_ce_fused_grad": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    # x, targets, lse, g, dx, T, W (columns of x), c0, V, eps, dtype, stream
    "ltt_ce_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _I, _P),
    # q, k_pool, v_pool, k_scale (or null), v_scale (or null), tables,
    # lengths, out, workspace (or null), S, Hq, Hkv, ps, hd, max_pages, scale,
    # dtype, pool_dtype, route (0 picks, 1 classic, 2 split), route taken
    # (out), stream
    "ltt_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _I, _I, _I, _IP, _P),
    # q, k_pool, v_pool, S, W, Hq, Hkv, ps, hd, max_pages, dtype, route,
    # workspace bytes (out)
    "ltt_paged_workspace": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LLP),
    # h, q4, s4, out, workspace (or null), M, N, K, group, dtype, route (0
    # picks, 1 classic, 2 stream, 3 mma), route taken (out), stream
    "ltt_w4_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _IP, _P),
    # h, q4, s4, M, N, K, group, dtype, route, workspace bytes (out)
    "ltt_w4_gemm_workspace": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _LLP),
    # q, k_pool, v_pool, k_scale (or null), v_scale (or null), tables,
    # lengths, out, workspace (or null), S, W, Hq, Hkv, ps, hd, max_pages,
    # scale, dtype, pool_dtype, route, route taken (out), stream
    "ltt_paged_window_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _I, _IP, _P),
    # x, y (may be x), rows, cols, dtype, route (0 picks, 1 classic, 2
    # vec), stream
    "ltt_softmax_rows": (_P, _P, _I, _I, _I, _I, _P),
    # x, y (may be x), rows, cols, dtype, route (0 picks, 1 classic, 2
    # cluster), route taken, stream
    "ltt_softmax_online": (_P, _P, _I, _I, _I, _I, _IP, _P),
    # x, w, out, N, C, H, W, c_out, kh, kw, ph, pw, dtype, stream
    "ltt_conv_planewise": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, w, out, N, C, H, W, c_out, kh, kw, ph, pw, sh, sw, ldw (weight row
    # stride), dtype, route (0 picks, 1 classic, 2 ffma, 3 mma), route taken
    # (out), stream
    "ltt_conv_direct": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _IP, _P),
    # x, y, B, R, C, element size, stream
    "ltt_transpose": (_P, _P, _I64, _I64, _I64, _I, _P),
    # x, N, element size, stream
    "ltt_transpose_inplace": (_P, _I64, _I, _P),
    # p, g, m, v, n, lr (device) or null, lr, b1, b2, 1 - b1, 1 - b2, eps, wd,
    # (bc1, bc2) (device) or null, bc1, bc2, has_wd, dtype, stream
    "ltt_adamw": (_P, _P, _P, _P, _I64, _P, _F, _F, _F, _F, _F, _F, _F, _P, _F, _F, _I, _I, _P),
    # p, g, m, n, lr (device) or null, lr, mu, nesterov, dtype, stream
    "ltt_sgdm": (_P, _P, _P, _I64, _P, _F, _F, _I, _I, _P),
    # table (int64: p, g, m, n of each leaf), leaves, lr (device) or null, lr,
    # mu, nesterov, dtype, stream
    "ltt_sgdm_multi": (_P, _I, _P, _F, _F, _I, _I, _P),
    # src, f, dst, rows, cols, colour (0 red, 1 black, 2 Jacobi), dtype, stream
    "ltt_stencil_sweep": (_P, _P, _P, _I, _I, _I, _I, _P),
    # a, b, b's K-major twin (int8, or null), c (or null), out, M, N, gm, gn,
    # gk, bm, bn, bk, alpha, beta, in_dtype, out_dtype, fast (the classic
    # kernels' blocks route), route (0 picks, 1 classic, 2 wgmma, 3 simt),
    # route taken (out), stream
    "ltt_gemm_packed": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _D, _D, _I, _I, _I,
                        _I, _IP, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (non-zero cudaGetLastError)."""


def build_cache(fn: Callable) -> Callable:
    """Memoize a builder on its (hashable) static arguments; log misses at
    DEBUG on the ``laser_tpu_torch`` logger."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        misses = cached.cache_info().misses
        t0 = time.perf_counter()
        out = cached(*args, **kwargs)
        if cached.cache_info().misses > misses:
            logger.debug("built %s%r in %.3fs", fn.__name__, args,
                         time.perf_counter() - t0)
        return out

    wrapper.cache_info = cached.cache_info  # type: ignore[attr-defined]
    wrapper.cache_clear = cached.cache_clear  # type: ignore[attr-defined]
    return wrapper


# ---------------------------------------------------------------------------
# Kernel records and counters
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Kernel:
    name: str
    source: str      # CUDA source, relative to the repository root
    replaces: str    # the TPU kernel it replaces, file:line function
    launches: int = 0
    plain_calls: int = 0


KERNELS: Dict[str, Kernel] = {}


def kernel(name: str, source: str, replaces: str) -> Kernel:
    return KERNELS.setdefault(name, Kernel(name, source, replaces))


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.plain_calls = 0


def counts() -> Dict[str, Dict[str, int]]:
    return {n: {"launches": k.launches, "plain_calls": k.plain_calls}
            for n, k in KERNELS.items()}


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises. Kernels launch on the
    current device, so a tensor on another card raises too."""
    if t.is_cuda:
        # read without building device objects: every launch pays for it
        if t.get_device() != torch._C._cuda_getDevice():
            raise ValueError(f"tensor on {t.device}, current device is "
                             f"cuda:{torch.cuda.current_device()}")
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernel or plain path for device {t.device}")


def route_code(routes: Dict[Optional[str], int], route: Optional[str]) -> int:
    """The launcher's code of a route name (None: the launcher picks)."""
    if route not in routes:
        raise ValueError(f"unknown route {route!r}; have {[r for r in routes if r]}")
    return routes[route]


# workspace bytes by (entry point, shape, dtype, route, alignment, device):
# the answer depends on nothing else, so each shape asks the library once
_WORKSPACE: Dict[tuple, int] = {}


def workspace(query: str, key: tuple, *args) -> int:
    """Bytes of fp32 scratch a launch needs: the library's ``query`` entry
    point on ``args`` (its last parameter the answer), asked once per
    ``key`` (which must determine it). Raises where the route asked for does
    not fit."""
    got = _WORKSPACE.get(key)
    if got is None:
        out = ctypes.c_longlong(0)
        check_launch(getattr(load_library(), query)(*args, ctypes.byref(out)), query)
        got = _WORKSPACE[key] = out.value
    return got


# one scratch buffer a device, with the stream it was allocated on, grown
# to the largest size asked for: the launches of one stream run in order,
# so a call reuses it once the call before it is done with it. A call on
# another stream, or one that needs more, allocates anew; the buffer it
# drops goes back to the caching allocator, which reuses it only on the
# stream it was allocated on
_SCRATCH: Dict[int, tuple] = {}


def scratch(nbytes: int, device) -> Optional[torch.Tensor]:
    """An fp32 scratch tensor of at least ``nbytes`` (None for 0) for a
    launch on the current stream of ``device``: no allocation on a
    host-bound decode step. Under CUDA graph capture a new one from the
    graph's pool, so that no buffer a graph holds is ever dropped."""
    if not nbytes:
        return None
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    held = _SCRATCH.get(device.index)
    if held is None or held[0] != stream or held[1].numel() * 4 < nbytes:
        held = _SCRATCH[device.index] = (
            stream, torch.empty(nbytes // 4, dtype=torch.float32, device=device))
    return held[1]


# one zeroed byte workspace a (device, stream, size) for kernels that keep a
# counter in it which their last block resets to 0 (the staged reduction's
# one launch): made once a stream, outside graph capture, and kept, so a call
# needs no allocation or memset; two streams never share one
_STREAM_WORK: Dict[tuple, torch.Tensor] = {}


def stream_workspace(t: torch.Tensor, nbytes: int) -> Optional[torch.Tensor]:
    """The current stream's zeroed workspace of ``nbytes`` on ``t``'s device,
    or None under CUDA graph capture, where the caller takes a route that
    keeps no counter: replays of a graph would share a live one."""
    if torch.cuda.is_current_stream_capturing():
        return None
    dev = t.get_device()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev), nbytes)
    w = _STREAM_WORK.get(key)
    if w is None:
        w = _STREAM_WORK[key] = torch.zeros(nbytes, dtype=torch.uint8, device=t.device)
    return w


def check_launch(status: int, name: str) -> None:
    if status != 0:
        raise KernelLaunchError(
            f"{name}: CUDA error {status} at launch "
            f"({torch.cuda.get_device_name() if torch.cuda.is_available() else '?'})")


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def find_nvcc() -> Optional[str]:
    """nvcc from $CUDA_HOME, then PATH, then the default toolkit location."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def cuda_sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build_library() -> Path:
    """Compile csrc/*.cu for sm_90a into one shared library (once per
    source hash): one nvcc process per source, all started together, then
    one link. nvcc's output, register and spill counts included, is kept in
    ``nvcc.log`` beside the library."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (searched $CUDA_HOME/bin, PATH and "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels are compiled from "
            f"{CSRC_DIR} at their first use on a CUDA tensor and need the "
            "CUDA toolkit")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in cuda_sources():
        obj = out.parent / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]}: exit code {proc.returncode}\n{text[-4000:]}")
    if not failed:
        cmd = [nvcc, *NVCC_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(f"link: exit code {r.returncode}\n{r.stderr[-4000:]}")
    (out.parent / "nvcc.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    logger.info("built %s in %.1fs", out, time.perf_counter() - t0)
    return out


@build_cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use (a failure is not cached)."""
    path = build_library()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    for fname, argtypes in SIGNATURES.items():
        fn = getattr(lib, fname)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


# the library's entry points by name, each looked up once
_ENTRIES: Dict[str, Callable] = {}


def entry(name: str) -> Callable:
    """The library's entry point ``name``, loaded on first use and kept: a
    wrapper whose launch is host-bound calls it without ``load_library``'s
    cache bookkeeping."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(load_library(), name)
    return fn


# ---------------------------------------------------------------------------
# Generated sources (the elementwise and reduction templates)
# ---------------------------------------------------------------------------

GEN_ROOT = BUILD_ROOT / "gen"
GEN_LIB = "libltt_gen.so"
# builds of generated sources in this process (cache hits on disk count as
# loads, not builds) and the wall seconds they took
GEN_BUILDS = {"built": 0, "loaded": 0, "seconds": 0.0}

# every generated library exports one entry point of its kind
GEN_SIGNATURES = {
    # in[], out[], n, stream
    "ltt_gen_for_each": (_P, _P, _I64, _P),
    # in[], out, rows, cols, stream
    "ltt_gen_row_reduce": (_P, _P, _I64, _I64, _P),
    # in[], partials, result (or null: partials only), n, combine op, stream
    "ltt_gen_map_reduce": (_P, _P, _P, _I64, _I, _P),
    # in[] (each operand's logical element 0), out[], geometry (int64: the
    # merged rank, shape, then each operand's strides), route, route taken
    # (out), stream
    "ltt_gen_for_each_strided": (_P, _P, _P, _I, _IP, _P),
    # in[], partials[] (one per leaf), results[] (one per result leaf), n, stream
    "ltt_gen_map_reduce_staged": (_P, _P, _P, _I64, _P),
    # in[], results[], workspace (a counter, then the fold's accumulators), n, stream
    "ltt_gen_map_reduce_staged_one": (_P, _P, _P, _I64, _P),
}


@functools.lru_cache(maxsize=None)
def _headers_digest(csrc: Path, flags: tuple) -> bytes:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(csrc.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.digest()


def generated_hash(text: str) -> str:
    """Key of a generated source: its text, every csrc/*.cuh it may include
    (read once per process), and the flags."""
    h = hashlib.sha256(_headers_digest(CSRC_DIR, NVCC_FLAGS))
    h.update(text.encode())
    return h.hexdigest()[:16]


def _gen_start(text: str):
    """(path, process or None): start nvcc on ``text`` unless its library
    exists already."""
    out = GEN_ROOT / generated_hash(text) / GEN_LIB
    if out.is_file():
        return out, None
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (searched $CUDA_HOME/bin, PATH and "
            f"{DEFAULT_CUDA_HOME}/bin): generated kernels are compiled at their "
            "first use on a CUDA tensor and need the CUDA toolkit")
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.parent / "body.cu"
    src.write_text(text)
    tmp = out.with_name(f"{GEN_LIB}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", f"-I{CSRC_DIR}", str(src), "-o", str(tmp)]
    return out, (cmd, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))


def _gen_finish(out: Path, job) -> None:
    if job is None:
        return
    cmd, tmp, proc = job
    log, _ = proc.communicate()
    (out.parent / "nvcc.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on the generated source {out.parent / 'body.cu'}"
                               f" (exit code {proc.returncode}):\n{log[-6000:]}")
    os.replace(tmp, out)


# the loaded library of each generated source, keyed by its text
_GEN_LOADED: Dict[str, ctypes.CDLL] = {}


def _gen_open(out: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise KernelBuildError(f"cannot load {out}: {e}") from e
    for fname, argtypes in GEN_SIGNATURES.items():
        fn = getattr(lib, fname, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def load_generated_many(texts) -> list:
    """The libraries of several generated sources, built together: one nvcc
    process per text not yet built, all started at once."""
    texts = list(texts)
    todo = [t for t in dict.fromkeys(texts) if t not in _GEN_LOADED]
    if todo:
        t0 = time.perf_counter()
        jobs = {t: _gen_start(t) for t in todo}
        errors = []
        for t, (out, job) in jobs.items():
            try:
                _gen_finish(out, job)
            except KernelBuildError as e:
                errors.append(str(e))
                continue
            _GEN_LOADED[t] = _gen_open(out)
            GEN_BUILDS["built" if job is not None else "loaded"] += 1
        if any(job is not None for _, job in jobs.values()):
            GEN_BUILDS["seconds"] += time.perf_counter() - t0
        if errors:
            raise KernelBuildError("\n".join(errors))
    return [_GEN_LOADED[t] for t in texts]


def load_generated(text: str) -> ctypes.CDLL:
    """The library of one generated source, built on first use."""
    lib = _GEN_LOADED.get(text)
    return lib if lib is not None else load_generated_many([text])[0]


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value (read
    raw: building a torch.cuda.Stream object would cost every launch host
    time)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
