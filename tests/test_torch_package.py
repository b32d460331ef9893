"""laser_tpu_torch package-level properties: no JAX, the kernel loader, the
device table, config, conversion and sampling."""

import ctypes
import subprocess
import sys

import numpy as np
import pytest
import torch

from laser_tpu_torch import config, device_info, registry
from laser_tpu_torch.convert import params_from_numpy
from laser_tpu_torch.ops.sampling import row_seed, sample_logits_batch


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import laser_tpu_torch.serving, laser_tpu_torch.models.transformer\n"
            "import laser_tpu_torch.convert, laser_tpu_torch.device_info\n"
            "import laser_tpu_torch.ops.attention_bwd, laser_tpu_torch.ops.loss\n"
            "import laser_tpu_torch.ops.optim, laser_tpu_torch.ops.attention\n"
            "import laser_tpu_torch.models.llama, laser_tpu_torch.ops.rope\n"
            "import laser_tpu_torch.ops.gemm.int4_kernel\n"
            "import laser_tpu_torch.models.cnn, laser_tpu_torch.models.mlp\n"
            "import laser_tpu_torch.ops.conv, laser_tpu_torch.ops.vector_math\n"
            "import laser_tpu_torch.ops.foreach, laser_tpu_torch.ops.codegen\n"
            "import laser_tpu_torch.ops.reductions, laser_tpu_torch.lux\n"
            "import laser_tpu_torch.tensor, laser_tpu_torch.ops.strided\n"
            "import laser_tpu_torch.ops.transpose, laser_tpu_torch as ltt\n"
            "import laser_tpu_torch.ops.quant, laser_tpu_torch.ops.gemm.batched\n"
            "import laser_tpu_torch.ops.gemm.f64_kernel, laser_tpu_torch.ops.gemm.int64_kernel\n"
            "ltt.transpose2d, ltt.mean_var, ltt.TensorView, ltt.gemm_quantized\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'laser_tpu' not in sys.modules, 'laser_tpu imported'\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_loader_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(registry, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(registry, "BUILD_ROOT", tmp_path / "build")
    registry.load_library.cache_clear()
    assert registry.find_nvcc() is None
    with pytest.raises(registry.KernelBuildError, match="nvcc not found"):
        registry.load_library()
    registry.load_library.cache_clear()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").rglob("*.so"))


def test_generated_sources_key_and_build_error(monkeypatch, tmp_path):
    """A generated source is keyed on its text and every csrc/*.cuh; without
    nvcc its first use raises KernelBuildError."""
    from laser_tpu_torch.ops.foreach import for_each_source

    src = for_each_source(lambda x: x + 1, torch.ones(3))
    h = registry.generated_hash(src)
    assert h != registry.generated_hash(src + "\n")
    monkeypatch.setattr(registry, "CSRC_DIR", tmp_path)
    assert registry.generated_hash(src) != h  # the headers are part of the key
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(registry, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(registry, "GEN_ROOT", tmp_path / "gen")
    with pytest.raises(registry.KernelBuildError, match="nvcc not found"):
        registry.load_generated(src)
    assert set(registry.GEN_SIGNATURES) == {"ltt_gen_for_each", "ltt_gen_row_reduce",
                                            "ltt_gen_map_reduce", "ltt_gen_for_each_strided",
                                            "ltt_gen_map_reduce_staged",
                                            "ltt_gen_map_reduce_staged_one"}


def test_cpu_tensors_never_build(monkeypatch):
    from laser_tpu_torch.ops.norm import NORM, layer_norm

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(registry, "load_library", no_build)
    before = (NORM.launches, NORM.plain_calls)
    layer_norm(torch.ones(2, 8))
    assert (NORM.launches, NORM.plain_calls) == (before[0], before[1] + 1)


def test_every_slice_kernel_registered():
    import laser_tpu_torch.lux  # noqa: F401
    import laser_tpu_torch.models.cnn  # noqa: F401
    import laser_tpu_torch.models.transformer  # noqa: F401
    import laser_tpu_torch.ops.quant  # noqa: F401
    import laser_tpu_torch.ops.reductions  # noqa: F401
    import laser_tpu_torch.ops.stencil  # noqa: F401
    import laser_tpu_torch.ops.strided  # noqa: F401
    import laser_tpu_torch.ops.transpose  # noqa: F401
    import laser_tpu_torch.serving  # noqa: F401

    assert set(registry.KERNELS) == {
        "gemm", "norm", "flash_attention", "paged_attention", "w4_gemm",  # serving
        "paged_window_attention",  # speculative verify
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "ce_fwd", "ce_fused_grad",
        "ce_bwd",  # the two-kernel CE gradient and the chunked LM loss
        "conv_planewise", "conv_direct", "softmax", "softmax_online",  # CNN
        "for_each", "for_each_multi", "row_reduce", "map_reduce",  # generated bodies
        "for_each_strided", "map_reduce_staged",  # generated, layout slice
        "transpose", "transpose_inplace",  # layout slice
        "gemm_batched", "gemm_int32", "gemm_limbs", "quantize_int8",  # GEMM dtype table
        "gemm_packed", "stencil_sweep", "adamw_update", "sgdm_update",  # the library surface
        "gemm_wgmma", "gemm_batched_wgmma", "flash_attention_mma",  # the Hopper routes
        "gemm_splitk", "w4_gemm_stream", "w4_gemm_mma",  # the weight-streaming routes
        "flash_attention_bwd_dq_mma", "flash_attention_bwd_dkv_mma",  # the backward's
        "conv_direct_ffma", "conv_direct_mma", "gemm_packed_wgmma",  # the conv's, packed
        "paged_attention_split", "paged_window_attention_split", "norm_vec",  # split KV, norm
        "gemm_simt", "gemm_packed_simt",  # the f32 FFMA skeleton
        "gemm_i8_wgmma", "gemm_limbs_wgmma", "gemm_int32_wgmma",  # the int8 wgmma skeleton
        "softmax_vec", "sgdm_multi",  # the row softmax in registers, the multi-tensor SGD
        "gemm_packed_i8_wgmma", "map_reduce_staged_one",  # packed int8 wgmma, staged one launch
        "for_each_strided_tiled", "softmax_online_cluster"}  # strided tiles, the online cluster
    assert set(registry.SIGNATURES) == {
        "ltt_gemm", "ltt_norm", "ltt_flash_fwd", "ltt_paged_attention", "ltt_w4_gemm",
        "ltt_paged_window_attention",
        "ltt_flash_bwd_dq", "ltt_flash_bwd_dkv", "ltt_ce_fwd", "ltt_ce_fused_grad",
        "ltt_ce_bwd",
        "ltt_conv_planewise", "ltt_conv_direct", "ltt_softmax_rows", "ltt_softmax_online",
        "ltt_transpose", "ltt_transpose_inplace",
        "ltt_gemm_batched", "ltt_gemm_limbs", "ltt_gemm_int32", "ltt_quantize_int8",
        "ltt_gemm_packed", "ltt_stencil_sweep", "ltt_adamw", "ltt_sgdm", "ltt_sgdm_multi",
        "ltt_gemm_workspace", "ltt_w4_gemm_workspace", "ltt_paged_workspace"}
    # alpha and beta are doubles: an int8 GEMM's int32 alpha passes exactly
    assert registry.SIGNATURES["ltt_gemm"][11:13] == (ctypes.c_double, ctypes.c_double)
    assert registry.SIGNATURES["ltt_quantize_int8"][8] is ctypes.c_int64  # the seed's 64 bits
    replaced = {k.name: k.replaces for k in registry.KERNELS.values()}
    assert replaced["gemm_batched"] == "laser_tpu/ops/gemm/batched.py:28 _build_batched"
    assert replaced["gemm_int32"] == "laser_tpu/ops/gemm/int32_kernel.py:65 build_gemm_int32"
    assert replaced["gemm_limbs"] == "laser_tpu/ops/gemm/limb_kernel.py:75 build_gemm_limbs"
    assert replaced["quantize_int8"] == "laser_tpu/ops/quant.py:29 _build_quantize"
    assert replaced["transpose"] == "laser_tpu/ops/transpose.py:42 _build_transpose"
    assert replaced["gemm_packed"] == "laser_tpu/ops/gemm/prepacked.py:80 _build_packed_gemm"
    assert replaced["stencil_sweep"] == "laser_tpu/ops/stencil.py:56 _build_sweeps"
    assert replaced["adamw_update"] == "laser_tpu/ops/optim.py:38 _build_adamw"
    assert replaced["sgdm_update"] == "laser_tpu/ops/optim.py:80 _build_sgdm"
    assert replaced["ce_bwd"] == "laser_tpu/ops/loss.py:130 _build_ce_bwd"
    # each route of one TPU kernel counts its own launches
    assert replaced["gemm_wgmma"] == replaced["gemm_splitk"] == replaced["gemm_simt"] == \
        replaced["gemm_i8_wgmma"] == replaced["gemm"] == "laser_tpu/ops/gemm/kernel.py:62 build_gemm"
    assert replaced["gemm_limbs_wgmma"] == replaced["gemm_limbs"]
    assert replaced["gemm_int32_wgmma"] == replaced["gemm_int32"]
    assert replaced["conv_direct_ffma"] == replaced["conv_direct_mma"] == \
        replaced["conv_direct"] == "laser_tpu/ops/conv.py:152 _build_direct_conv"
    assert replaced["gemm_packed_wgmma"] == replaced["gemm_packed_simt"] == \
        replaced["gemm_packed_i8_wgmma"] == replaced["gemm_packed"]
    assert replaced["softmax_vec"] == replaced["softmax"] == "laser_tpu/ops/vector_math.py:276 softmax"
    assert replaced["sgdm_multi"] == replaced["sgdm_update"]
    assert replaced["w4_gemm_stream"] == replaced["w4_gemm_mma"] == replaced["w4_gemm"] == \
        "laser_tpu/ops/gemm/int4_kernel.py:87 build_w4_gemm"
    assert replaced["gemm_batched_wgmma"] == replaced["gemm_batched"]
    assert replaced["flash_attention_mma"] == replaced["flash_attention"]
    assert replaced["flash_attention_bwd_dq_mma"] == replaced["flash_attention_bwd_dq"]
    assert replaced["flash_attention_bwd_dkv_mma"] == replaced["flash_attention_bwd_dkv"]
    for fname in ("ltt_gemm", "ltt_gemm_batched", "ltt_flash_fwd", "ltt_w4_gemm",
                  "ltt_flash_bwd_dq", "ltt_flash_bwd_dkv"):
        # route, route taken
        assert registry.SIGNATURES[fname][-3:-1] == (ctypes.c_int, ctypes.POINTER(ctypes.c_int))
    assert registry.SIGNATURES["ltt_ce_bwd"][9] is ctypes.c_double  # eps, q formed in double
    assert replaced["transpose_inplace"].startswith(
        "laser_tpu/ops/transpose.py:151 _build_inplace_transpose_pipelined")
    assert replaced["for_each_strided"] == replaced["for_each_strided_tiled"] == \
        "laser_tpu/ops/strided.py:222 build_strided_foreach"
    assert replaced["softmax_online_cluster"] == replaced["softmax_online"] == \
        "laser_tpu/ops/vector_math.py:200 _softmax_online"
    # the strided and online launchers take a route and report the one taken
    assert registry.GEN_SIGNATURES["ltt_gen_for_each_strided"][3:5] == \
        registry.SIGNATURES["ltt_softmax_online"][5:7] == (ctypes.c_int, ctypes.POINTER(ctypes.c_int))
    assert replaced["map_reduce_staged"] == replaced["map_reduce_staged_one"] == \
        "laser_tpu/ops/foreach.py:442 map_reduce_staged"
    for k in registry.KERNELS.values():
        assert (registry.PACKAGE_DIR.parent / k.source).is_file()
        assert k.replaces.startswith("laser_tpu/")


@pytest.mark.parametrize("name,key", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"), ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 NVL", "h100-nvl"), ("NVIDIA A100-SXM4-80GB", None)])
def test_device_table(name, key):
    assert device_info.classify_device_name(name) == key
    if key is None:
        with pytest.raises(KeyError):
            device_info.detect(name)
    else:
        assert device_info.detect(name).sms in (114, 132)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_unported_matmul_precision_raises(precision):
    from laser_tpu_torch.ops.gemm import gemm

    with config.config_override(matmul_precision=precision):
        with pytest.raises(NotImplementedError):
            gemm(torch.ones(2, 3), torch.ones(3, 4), bias=torch.zeros(4))


def test_params_from_numpy_bfloat16_exact():
    import ml_dtypes

    a = np.asarray([1.5, -2.25, 3e-3], np.float32).astype(ml_dtypes.bfloat16)
    t = params_from_numpy({"w": [a]}, device="cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_sampler_greedy_and_seeded():
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [5.0, 0.0, 1.0, 0.0]])
    greedy = sample_logits_batch([0, 0], [3, 3], logits, [0.0, 0.0], [0, 0], [1.0, 1.0])
    assert greedy.tolist() == [1, 0]  # first index on ties, as jnp.argmax
    a = sample_logits_batch([7, 7], [3, 4], logits, [1.0, 1.0], [2, 0], [1.0, 0.5])
    b = sample_logits_batch([7, 7], [3, 4], logits, [1.0, 1.0], [2, 0], [1.0, 0.5])
    assert a.tolist() == b.tolist()
    assert a[0].item() in (1, 2)   # top-k 2 keeps only the two 2.0 logits
    assert a[1].item() == 0        # top-p 0.5: the 5.0 logit alone holds > 0.5
    assert row_seed(7, 3) != row_seed(7, 4)


@pytest.mark.parametrize("make", ["init_transformer", "init_decode_cache", "PagedKVCache",
                                  "params_from_numpy", "init_llama", "init_llama_cache",
                                  "rope_tables", "init_cnn", "init_mlp"])
def test_entry_points_default_to_the_card(make):
    """Without a device argument the entry points allocate on CUDA, so on a
    machine without a card they raise PyTorch's own error."""
    import inspect

    from laser_tpu_torch.models import cnn, llama, mlp, transformer
    from laser_tpu_torch.ops import rope
    from laser_tpu_torch.serving import engine

    fn = {"init_transformer": transformer.init_transformer,
          "init_decode_cache": transformer.init_decode_cache,
          "PagedKVCache": engine.PagedKVCache.__init__,
          "params_from_numpy": params_from_numpy,
          "init_llama": llama.init_llama, "init_llama_cache": llama.init_llama_cache,
          "rope_tables": rope.rope_tables, "init_cnn": cnn.init_cnn,
          "init_mlp": mlp.init_mlp}[make]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


# laser_tpu's root names with no port yet, each with its ROADMAP.md item
UNPORTED_ROOT_NAMES = {
    "conv2d_trainable": "queue 1, item 11",
    "sample_logits": "queue 1, item 10",
    "sample_multinomial": "queue 1, item 10",
    "sample_multinomial_batch": "queue 1, item 10",
    "ChipSpec": "TPU-only (device_info.detect gives the card's spec)",
    "min_tile": "TPU-only (the (8, 128) tiling)",
    "num_devices": "queue 1, item 14 (the mesh)",
}


def _laser_tpu_root_names():
    """(name, laser_tpu module it comes from, or None) for every name
    laser_tpu/__init__.py binds at its root, read from the source: importing
    laser_tpu here would pull JAX into this process."""
    import ast
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "laser_tpu" / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [(a.asname or a.name, node.module) for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [(t.id, None) for t in node.targets if isinstance(t, ast.Name)]
    return names


def test_package_exports_laser_tpus_names():
    """Every name laser_tpu/__init__.py binds at its root resolves lazily on
    laser_tpu_torch to the port's object (its submodules to the port's
    submodules), but for the explicit list of names with no port yet."""
    import importlib
    import importlib.util

    import laser_tpu_torch as ltt

    names = _laser_tpu_root_names()
    assert len(names) == 78 and set(UNPORTED_ROOT_NAMES) <= {n for n, _ in names}
    for name, module in names:
        if name in UNPORTED_ROOT_NAMES:
            with pytest.raises(AttributeError):
                getattr(ltt, name)
        elif name == "__version__":
            assert ltt.__version__ == "0.1.0"
        elif module is None:  # from . import config, device_info, ...
            assert getattr(ltt, name) is importlib.import_module(f"laser_tpu_torch.{name}")
        else:
            got = getattr(ltt, name)
            home = importlib.import_module(f"laser_tpu_torch.{ltt._EXPORTS[name]}")
            assert got is getattr(home, name), name
            assert getattr(got, "__module__", "").startswith("laser_tpu_torch."), name
            # where the port mirrors laser_tpu's module, the name is that one's
            mirror = f"laser_tpu_torch.{module}"
            if importlib.util.find_spec(mirror) and hasattr(importlib.import_module(mirror),
                                                             name):
                assert got is getattr(importlib.import_module(mirror), name), name
    from laser_tpu_torch import tensor
    from laser_tpu_torch.ops import foreach, reductions, transpose

    assert ltt.TensorView is tensor.TensorView and ltt.as_view is tensor.as_view
    assert ltt.zeros is tensor.zeros and ltt.from_nested is tensor.from_nested
    assert ltt.row_major_strides is tensor.row_major_strides
    assert ltt.map_reduce_staged is foreach.map_reduce_staged
    assert (ltt.mean_var, ltt.argmax, ltt.argmin) == (reductions.mean_var, reductions.argmax,
                                                       reductions.argmin)
    assert (ltt.transpose2d, ltt.transpose2d_batched, ltt.nchw2nhwc, ltt.nhwc2nchw) == (
        transpose.transpose2d, transpose.transpose2d_batched, transpose.nchw2nhwc,
        transpose.nhwc2nchw)
    from laser_tpu_torch.ops import gemm, quant

    assert (ltt.gemm, ltt.gemm_ad, ltt.linear) == (gemm.gemm, gemm.gemm_ad, gemm.linear)
    assert (ltt.gemm_strided, ltt.gemm_batched) == (gemm.gemm_strided, gemm.gemm_batched)
    assert (ltt.quantize_int8, ltt.dequantize_int8, ltt.gemm_quantized) == (
        quant.quantize_int8, quant.dequantize_int8, quant.gemm_quantized)
    with pytest.raises(AttributeError):
        ltt.not_a_name  # noqa: B018
    from laser_tpu_torch.ops import optim, stencil

    assert (ltt.gemm_packed, ltt.gemm_prepack_a, ltt.gemm_prepack_b) == (
        gemm.gemm_packed, gemm.gemm_prepack_a, gemm.gemm_prepack_b)
    assert (ltt.PackedMatrix, ltt.GemmTiles, ltt.plan_tiles) == (
        gemm.PackedMatrix, gemm.GemmTiles, gemm.plan_tiles)
    assert ltt.stencil_solve is stencil.stencil_solve
    assert ltt.sgd_momentum_step is optim.sgd_momentum_step
