"""laser_tpu_torch: the PyTorch + CUDA port of laser_tpu for NVIDIA Hopper.

It mirrors laser_tpu's layout (``ops/``, ``models/``, ``serving/``) and keeps
its weight layouts, so each port module sits where its JAX counterpart does
and both compute the same function on the same numbers. Every TPU kernel on
a ported path is a hand-written CUDA C++ kernel under ``csrc/``, built by
``registry.load_library`` at its first use on a CUDA tensor; on CPU tensors
each wrapper runs the kernel's plain PyTorch version. The user-facing paths
ported: serving (``serving.ServingEngine``) of both model families,
``models.transformer`` and ``models.llama``, with int8/int4 weights and int8
KV pages as options, training (``models.transformer.
transformer_train_step``), and the classifiers: ``models.cnn.cnn_predict``
over the conv and softmax kernels, ``models.mlp.mlp_predict`` and
``sgd_step``; and the primitives the README's quick start calls:
``ops.foreach`` (``for_each``, ``for_each_multi``, ``row_reduce``,
``map_reduce``), ``ops.vector_math`` exp/log/tanh/sigmoid and
``ops.reductions`` on them, and ``lux``, whose torch bodies
``ops.codegen`` translates into CUDA C++ for the templates of
``csrc/foreach.cuh``, built one library per body
(``registry.load_generated``). Entry points that allocate put their
tensors on the card unless the caller passes ``device``.

The layout and strided primitives (``tensor.TensorView``, ``for_each`` over
views through ``ops.strided``, ``ops.transpose``, ``map_reduce_staged`` and
``mean_var`` / ``argmax`` / ``argmin``) fill the templates of
``csrc/foreach.cuh`` and run ``csrc/transpose.cu``. ``ops.gemm`` has
laser_tpu's whole dtype table (int8 -> int32 on ``csrc/gemm.cu``; exact
int32, int64 and f64 GEMMs over ``csrc/limb_gemm.cu``), ``gemm_strided``
and ``gemm_batched``; ``ops.quant`` int8 quantization
(``csrc/quantize.cu``) and ``gemm_quantized``. The rest of laser_tpu's
library surface: the prepacked GEMM (``ops.gemm.prepacked`` with
``tiling.plan_tiles``, ``csrc/packed_gemm.cu``), ``ops.stencil``'s
``stencil_solve`` (``csrc/stencil.cu``), and the fused AdamW and
SGD-momentum updates of ``ops.optim`` (``backend="pallas"``,
``csrc/optim.cu``).

Import the submodule you need: this package imports nothing eagerly. Every
name laser_tpu/__init__.py binds at its root that has a port is here too,
resolved from the port submodule that defines it at first use (its
submodules ``config``, ``device_info``, ``registry``, ``tensor`` and
``utils`` as well); ``conv2d_trainable``, ``sample_logits``,
``sample_multinomial``, ``sample_multinomial_batch``, ``ChipSpec``,
``min_tile`` and ``num_devices`` have none yet (ROADMAP.md).
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "TensorView": "tensor", "as_view": "tensor", "from_nested": "tensor",
    "row_major_strides": "tensor", "zeros": "tensor",
    "map_reduce_staged": "ops.foreach",
    "mean_var": "ops.reductions", "argmax": "ops.reductions", "argmin": "ops.reductions",
    "transpose2d": "ops.transpose", "transpose2d_batched": "ops.transpose",
    "nchw2nhwc": "ops.transpose", "nhwc2nchw": "ops.transpose",
    "gemm": "ops.gemm", "gemm_ad": "ops.gemm", "gemm_batched": "ops.gemm",
    "gemm_strided": "ops.gemm", "linear": "ops.gemm",
    "quantize_int8": "ops.quant", "dequantize_int8": "ops.quant",
    "gemm_quantized": "ops.quant",
    "gemm_packed": "ops.gemm", "gemm_prepack_a": "ops.gemm", "gemm_prepack_b": "ops.gemm",
    "PackedMatrix": "ops.gemm", "GemmTiles": "ops.gemm", "plan_tiles": "ops.gemm",
    "stencil_solve": "ops.stencil", "sgd_momentum_step": "ops.optim",
    "LaserConfig": "config", "config_override": "config", "get_config": "config",
    "set_config": "config", "detect": "device_info",
    "for_each": "ops.foreach", "for_each_staged": "ops.foreach", "map_reduce": "ops.foreach",
    "reduce_max": "ops.reductions", "reduce_mean": "ops.reductions",
    "reduce_min": "ops.reductions", "reduce_sum": "ops.reductions",
    "attention": "ops.attention", "attention_gqa": "ops.attention",
    "attention_gqa_trainable": "ops.attention", "attention_reference": "ops.attention",
    "attention_trainable": "ops.attention", "attention_with_stats": "ops.attention",
    "paged_attention": "ops.paged_attention",
    "paged_attention_reference": "ops.paged_attention",
    "layer_norm": "ops.norm", "rms_norm": "ops.norm",
    "adamw_init": "ops.optim", "adamw_step": "ops.optim",
    "accumulated_value_and_grad": "ops.optim", "clip_by_global_norm": "ops.optim",
    "global_norm": "ops.optim", "inverse_sqrt_lr": "ops.optim", "warmup_cosine_lr": "ops.optim",
    "exp": "ops.vector_math", "log": "ops.vector_math", "sigmoid": "ops.vector_math",
    "softmax": "ops.vector_math", "tanh": "ops.vector_math",
    "conv2d_direct": "ops.conv", "conv2d_im2col": "ops.conv",
    "sample_logits_batch": "ops.sampling",
    "cross_entropy": "ops.loss", "lm_cross_entropy": "ops.loss",
}
# laser_tpu's root also binds these submodules
_SUBMODULES = ("config", "device_info", "registry", "tensor", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
