"""Operators of the port. Import the submodule you need: ``ops.gemm``
(``gemm``, ``gemm_ad``, ``linear``, ``gemm_packed``, ``plan_tiles``),
``ops.gemm.int4_kernel`` (``gemm_w4``, ``quantize_int4``), ``ops.norm``,
``ops.rope``, ``ops.attention`` (``attention``, ``attention_gqa``,
``attention_with_stats``, ``attention_trainable``), ``ops.attention_bwd`` (``flash_attention_bwd``),
``ops.loss`` (``cross_entropy``, ``lm_cross_entropy``), ``ops.optim``
(``adamw_step``, ``sgd_momentum_step`` and friends), ``ops.stencil``
(``stencil_solve``), ``ops.paged_attention`` (``paged_attention``,
``quantize_kv``), ``ops.sampling``, ``ops.conv`` (``conv2d_direct``,
``conv2d_im2col``, ``conv_planewise``, ``conv_direct``), ``ops.vector_math``
(``softmax``, ``softmax_online``, ``exp``, ``log``, ``tanh``, ``sigmoid``),
``ops.foreach`` (``for_each``, also over strided views, ``for_each_multi``,
``row_reduce``, ``map_reduce``, ``map_reduce_staged``), ``ops.strided``
(``strided_for_each``), ``ops.reductions`` (``reduce_sum`` / ``min`` /
``max`` / ``mean``, ``mean_var``, ``argmax``, ``argmin``), ``ops.transpose``
(``transpose2d``, ``transpose2d_batched``, ``nchw2nhwc``, ``nhwc2nchw``),
``ops.codegen`` (body translation); nothing is imported eagerly here."""
