"""Operators of the port. Import the submodule you need (``ops.norm``,
``ops.attention``, ``ops.paged_attention``, ``ops.gemm``, ``ops.sampling``);
nothing is imported eagerly here."""
