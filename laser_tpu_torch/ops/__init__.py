"""Operators of the port. Import the submodule you need: ``ops.gemm``
(``gemm``, ``gemm_ad``, ``linear``), ``ops.norm``, ``ops.attention``
(``attention``, ``attention_with_stats``, ``attention_trainable``),
``ops.attention_bwd`` (``flash_attention_bwd``), ``ops.loss``
(``cross_entropy``, ``lm_cross_entropy``), ``ops.optim`` (``adamw_step``
and friends), ``ops.paged_attention``, ``ops.sampling``; nothing is imported
eagerly here."""
