#!/usr/bin/env python3
"""Time one laser_tpu_torch benchmark in two source trees, in turns on one
CUDA card.

    python3 scripts/time_in_turns.py BENCH TREE_A TREE_B

BENCH is one of:

- ``flash_forward``: the value-only flash forward ``attention(q, k, v,
  causal=True)`` under ``no_grad`` at the serving prefill's shape (slots x
  heads x the longest prefill bucket x head dim, bf16), with CUDA events:
  ``per_call_ms``, the median over 20 calls of one call between two events,
  as chip_smoke.py phase 2 times it (the wrapper's host work included);
  ``batched_ms``, 50 calls between two events, over 50, median of 5 runs
  (the device's time: the host enqueues faster than the kernel runs).
- ``flash_backward``: the flash backward's two kernels at chip_smoke.py
  phase 5's attention shape (batch x heads x sequence x head dim, causal,
  bf16), each on the route the library picks, from one stats forward:
  ``dq_ms`` and ``dkv_ms`` one call between two CUDA events (median of
  20), ``dq_batched_ms`` and ``dkv_batched_ms`` 20 calls between two events
  (median of 5).
- ``serving``: the single-step engine (``decode_burst=1``), each engine once
  to warm up and once timed (tokens/s, host clock, synchronised):
  ``transformer``, chip_smoke.py phase 3's model; ``llama_int4``, phase 7's
  run (b) (int4 block weights, int8 KV pages), the engine whose wall depends
  most on the host.
- ``cnn``: chip_smoke.py phase 12's ``cnn_predict`` (configuration C1, f32,
  16 images at 224x224) under ``no_grad``, after one warm-up forward:
  ``images_per_s``, 16 over the median of 20 synchronised forwards (host
  clock), as phase 12 prints it.
- ``conv``: the direct conv at chip_smoke.py phase 12's shapes on the
  route each tree's ``conv2d_direct`` picks: C1's convs 2 and 3 in f32,
  conv 3's input at stride 2 in f32 and bf16, conv 3 in bf16;
  ``<case>_ms`` one call between two CUDA events (median of 20),
  ``<case>_batched_ms`` 20 calls between two events (median of 5).
- ``wgmma_gemm``: the products of the wgmma skeleton at chip_smoke.py's
  shapes, bf16, each on the route the tree's library picks: ``linear``
  M4096 K2048 N8192 with bias and gelu (phase 2), ``gemm_batched`` B4
  4096^3 (phase 15), ``gemm_packed`` 4096^3 on the planned plan (phase
  16); timed as ``conv``.
- ``paged``: paged attention at chip_smoke.py phase 2's shapes, bf16 q, on
  the route each tree picks: the decode (8 slots, lengths 0..1024 over 16
  pages of 64: the serving engine's decode shape) over bf16 pages at 16
  heads and over int8 pages at Hq 32 / Hkv 8, and the verify (W 5, lengths
  5..1026) over the same pages; timed as ``conv``, ``<case>_graph_ms``, 20
  calls in a CUDA graph, and ``<case>_host_us``, the host's microseconds a
  call (100 calls enqueued, no sync before the clock stops); where the
  tree's wrappers take ``route=``, also the bf16 decode's and verify's
  host time on the classic kernels asked for (``<case>_classic_host_us``).
- ``norm``: the layer norm of 4096 x 2048 bf16 rows with bf16 gains and
  the RMS norm of 4096 x 4096 and 8 x 4096 (the Llama width), on the route
  each tree picks; timed as ``paged`` (no classic host times).
- ``f32_gemm``: the f32 products and the f32 paths that run them, on the
  route each tree picks: ``lux_relu``, row 1's f32 product (Lux's relu(a
  @ b + bias), M4096 K2048 N2048, phase 13) and ``packed``, row 32's
  (``gemm_packed`` 4096^3 on the planned plan, phase 16), timed as
  ``conv``; ``train_step_ms``, phase 6's f32 ``transformer_train_step``
  (2L d512, batch 4 x 256) and ``llama_loss_grad_ms``, its llama loss and
  gradients (the chunked branch), each the median of 10 synchronised
  calls after 2 (host clock).
- ``int_gemm``: the integer GEMMs of chip_smoke.py phase 15 at its shapes
  and data, on the route each tree picks: ``limbs``, ``gemm_limbs`` of
  the 8 x 8 int64 digit planes of 2048^3 into 8 buckets from (8, K, N)
  planes (one K-major copy in the call); ``limbs_kernel``, the same
  product from K-major planes where the tree has ``gemm_limbs_kmajor``
  (else as ``limbs``); ``int32``, the int32
  kernel on pre-split limbs (``gemm_int32_limbs``; ``int32_kernel``
  K-major where the tree has ``gemm_int32_limbs_kmajor``); ``int8``,
  ``gemm`` int8 4096^3 -> int32 (B row-major); ``f64``, ``gemm_f64``
  2048^3 at 8 slices end to end; ``packed_int8``, ``gemm_packed`` int8
  4096^3 on the planned plan (B packed once), and ``torch_int_mm_tn``,
  ``torch._int_mm`` on the same operands with B column-major; timed as
  ``conv``.
- ``softmax``: ``softmax(x)`` over the last axis on the route each tree
  picks, f32 randn * 4 rows at C1's head (16 x 1000: ``c1_*``) and at
  bench.py:421's 8192 x 4096 (``bench_*``), and ``torch.softmax`` on the
  same rows in the same process (``torch_c1_*``, ``torch_bench_*``); each
  timed as ``paged`` (one call, 20 in a row, 20 in a CUDA graph, the
  host's microseconds a call).
- ``sgd``: ``sgd_momentum_step(backend="pallas")`` over chip_smoke.py
  phase 16's tree (the 8L d2048 bf16 transformer's 99 leaves, 419.6 M
  parameters) with randn * 1e-3 gradients, zero momentum and lr a 0-d CUDA
  tensor, mu 0.9 (``sgd``) and Nesterov (``nesterov``), and
  ``torch.optim.SGD(fused=True).step`` over copies of the leaves
  (``torch_sgd``, ``torch_nesterov``); one call between two CUDA events
  (median of 20, ``<case>_ms``), 20 calls between two events
  (``<case>_batched_ms``, median of 5) and the host's microseconds a step
  (``<case>_host_us``, 20 steps enqueued).
- ``staged``: ``mean_var``, ``argmax`` and ``argmin`` of chip_smoke.py phase
  14's 8192 x 8192 f32 (randn * 3 + 1) on the route each tree picks and,
  where the tree's reductions take ``route=``, on the two-launch template
  asked for (``classic_*``), and ``torch.var_mean`` / ``torch.max`` /
  ``torch.min`` of the flattened tensor in the same process (``torch_*``);
  each timed as ``paged``. Then where a ``mean_var`` call's host time goes:
  the CPU self time of each torch operator it runs, a call
  (``split_<case>_<op>_us``, torch.profiler's CPU events over 200 calls;
  the profiler adds its own cost to each operator), for ``mean_var`` on the
  route the tree picks and on the two-launch template where asked for;
  what the operators leave of ``<case>_host_us`` is the wrapper's Python
  and its C launch.
- ``strided``: ``for_each(lambda p: p * 2.0, v)`` over every second row of
  chip_smoke.py phase 14's 16384 x 4096 f32, as a TensorView at offset 4096
  (``view``) and as ``x[1::2]`` (``every2row``), on the route the tree
  picks and, where the tree's ``strided_for_each`` takes ``route=``, on the
  classic kernel asked for (``classic_*``), and ``x[1::2] * 2.0``
  (``torch_every2row``); each timed as ``paged``, and as 20 calls in a CUDA
  graph over two copies of the buffer (``<case>_cold_graph_ms``; a call
  moves 268 MB, past L2 either way). Then the host's work a call, split as
  ``staged`` splits it (``split_<case>_<op>_us``), and what the torch
  operators leave of ``<case>_host_us``: the wrapper's Python and its C
  launch (``<case>_python_us``; the profiler's own cost falls on the
  operators, so this is a floor). Three more bodies over ``x[1::2]`` on
  the route the tree picks, timed the same way but for the cold graph:
  one that reads a module global (``body_global``), one that calls the
  accurate exp core and reads a global (``body_exp_acc``), and one that
  calls a Python function of the script's (``body_helper``).
- ``online_softmax``: ``softmax_online(x)`` over 64 rows of Llama-3's
  128256-word vocabulary (randn * 4) in f32 and bf16 on the route the tree
  picks and, where it takes ``route=``, on the classic online kernel asked
  for (``classic_*``), and ``torch.softmax`` on the same rows (``torch_*``);
  each timed as ``strided`` (the cold graph over copies of the rows past
  L2).
- ``primitives``: every case of chip_smoke.py phase 13 (for_each,
  for_each_multi, row_reduce, map_reduce, vector math, reductions, Lux at
  bench.py's shapes), its generated bodies built first: the kernel's ms as
  phase 13 times it (median of 20 calls, one call between two CUDA events).

Models, shapes, engine config and traffic are those of the chip_smoke.py
beside this script, the same for both trees. Each TREE is the root of a
checkout (for example the parent commit unpacked with ``git archive``, and
this one). The trees run in the order A, B, B, A, each in its own process
(the two packages share a name), so a drift of the card or of the host over
the run falls on both. Every process builds its tree's kernels into that
tree's ``build/``. Prints one JSON line per run, then the card's name and
power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py (its laser_tpu_torch imports are made
    inside its functions, so they reach the tree under test)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def flash_forward(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.attention import attention

    m, cfg = smoke.MODEL, smoke.SERVE_CFG
    shape = (cfg["max_seqs"], m["n_heads"], max(cfg["prefill_buckets"]),
             m["d_model"] // m["n_heads"])
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))

    def events(n: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            attention(q, k, v, causal=True)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    with torch.no_grad():
        events(5)
        per_call = statistics.median(events(1) for _ in range(20))
        batched = statistics.median(events(50) for _ in range(5))
    return {"shape": shape, "per_call_ms": per_call, "batched_ms": batched}


def flash_backward(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.attention import flash_forward
    from laser_tpu_torch.ops.attention_bwd import bwd_dkv_cuda, bwd_dq_cuda

    m, (B, S) = smoke.MODEL, smoke.TRAIN_BATCH
    shape = (B * m["n_heads"], S, m["d_model"] // m["n_heads"])
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    sc = shape[2] ** -0.5
    o, ms, ls = flash_forward(q, k, v, True, sc, stats=True)
    dvec = (do.float() * o.float()).sum(-1)
    fns = {"dq": lambda: bwd_dq_cuda(q, k, v, do, ms, ls, dvec, True, sc),
           "dkv": lambda: bwd_dkv_cuda(q, k, v, do, ms, ls, dvec, True, sc)}
    res = {"shape": shape}
    for name, fn in fns.items():
        res[f"{name}_ms"] = smoke.cuda_ms(fn)
        res[f"{name}_batched_ms"] = smoke.cuda_batched_ms(fn, reps=5)
    return res


def serving(smoke) -> dict:
    import torch

    from laser_tpu_torch.models.llama import init_llama
    from laser_tpu_torch.models.transformer import init_transformer
    from laser_tpu_torch.ops.rope import rope_tables

    def tokens_per_s(params, n_heads, model, **quant):
        prompts = smoke.traffic(params["embed"].shape[0])
        smoke.serve(params, n_heads, prompts, model=model, **quant)  # warm-up
        _, outs, wall = smoke.serve(params, n_heads, prompts, model=model, **quant)
        return sum(len(o) for o in outs) / wall

    res = {}
    params = init_transformer(0, dtype=torch.bfloat16, device="cuda", **smoke.MODEL)
    res["transformer"] = tokens_per_s(params, smoke.MODEL["n_heads"], "transformer")
    del params
    rope, H = smoke.LLAMA_ROPE, smoke.LLAMA["n_heads"]
    lp = init_llama(0, dtype=torch.bfloat16, device="cuda", max_len=rope["max_len"],
                    **smoke.LLAMA)
    lp["rope_cos"], lp["rope_sin"] = rope_tables(
        rope["max_len"], smoke.LLAMA["d_model"] // H, base=rope["base"], device="cuda")
    res["llama_int4"] = tokens_per_s(lp, H, "llama", **smoke.LLAMA_INT4, kv_quant=True)
    return res


def cnn(smoke) -> dict:
    import torch

    from laser_tpu_torch.models.cnn import cnn_predict, init_cnn

    params = init_cnn(0, device="cuda", **smoke.CNN)
    g = torch.Generator(device="cuda").manual_seed(12)
    hw = smoke.CNN["image_hw"]
    x = torch.randn((smoke.CNN_BATCH, smoke.CNN["in_channels"], hw, hw), generator=g,
                    device="cuda")
    with torch.no_grad():
        cnn_predict(params, x)
        return {"images_per_s": smoke.images_per_s(lambda: cnn_predict(params, x))}


def _timed(smoke, fns) -> dict:
    res = {}
    for name, fn in fns.items():
        res[f"{name}_ms"] = smoke.cuda_ms(fn)
        res[f"{name}_batched_ms"] = smoke.cuda_batched_ms(fn, reps=5)
    return res


def conv(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.conv import conv2d_direct

    g = torch.Generator(device="cuda").manual_seed(5)

    def inputs(xs, ws, dtype):
        x = torch.randn(xs, generator=g, device="cuda").to(dtype)
        w = (torch.randn(ws, generator=g, device="cuda") * (ws[1] * 9) ** -0.5).to(dtype)
        return x, w

    c2 = inputs((16, 20, 112, 112), (64, 20, 3, 3), torch.float32)
    c3 = inputs((16, 64, 56, 56), (64, 64, 3, 3), torch.float32)
    c3b = inputs((16, 64, 56, 56), (64, 64, 3, 3), torch.bfloat16)
    p1, s2 = (1, 1), (2, 2)
    return _timed(smoke, {
        "conv2_f32": lambda: conv2d_direct(*c2, p1), "conv3_f32": lambda: conv2d_direct(*c3, p1),
        "conv3_s2_f32": lambda: conv2d_direct(*c3, p1, s2),
        "conv3_bf16": lambda: conv2d_direct(*c3b, p1),
        "conv3_s2_bf16": lambda: conv2d_direct(*c3b, p1, s2)})


def wgmma_gemm(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.gemm import gemm_packed, gemm_prepack_a, gemm_prepack_b, linear
    from laser_tpu_torch.ops.gemm.batched import gemm_batched

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    x, w, bias = rnd(4096, 2048), rnd(2048, 8192, std=2048 ** -0.5), rnd(8192, std=0.1)
    ab, bb = rnd(4, 4096, 4096), rnd(4, 4096, 4096, std=4096 ** -0.5)
    n = smoke.PACKED_N
    pa, pb = gemm_prepack_a(rnd(n, n, std=0.05)), gemm_prepack_b(rnd(n, n, std=0.05))
    return _timed(smoke, {
        "linear_gelu": lambda: linear(x, w, bias, "gelu"),
        "batched": lambda: gemm_batched(ab, bb),
        "packed": lambda: gemm_packed(smoke.PACKED_ALPHA, pa, pb)})


def f32_gemm(smoke) -> dict:
    import time

    import torch

    from laser_tpu_torch.models import transformer as tf
    from laser_tpu_torch.models.llama import init_llama
    from laser_tpu_torch.ops.gemm import gemm_packed, gemm_prepack_a, gemm_prepack_b
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4096, 2048, generator=g, device="cuda")
    w = torch.randn(2048, 2048, generator=g, device="cuda") * 2048 ** -0.5
    bias = torch.randn(2048, generator=g, device="cuda") * 0.1
    n = smoke.PACKED_N
    pa = gemm_prepack_a(torch.randn(n, n, generator=g, device="cuda") * 0.05)
    pb = gemm_prepack_b(torch.randn(n, n, generator=g, device="cuda") * 0.05)
    res = _timed(smoke, {
        "lux_relu": lambda: gemm_fused(x, w, bias=bias, epilogue="relu"),
        "packed": lambda: gemm_packed(smoke.PACKED_ALPHA, pa, pb)})

    def step_ms(fn) -> float:
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    cfg, heads = smoke.MODEL_F32, smoke.MODEL_F32["n_heads"]
    params = tf.init_transformer(1, dtype=torch.float32, device="cuda", **cfg)
    state = tf.transformer_train_init(params)
    tokens = smoke.train_batch(cfg["vocab"], smoke.TRAIN_F32_BATCH, 1)
    res["train_step_ms"] = step_ms(lambda: tf.transformer_train_step(
        params, state, tokens, 1, n_heads=heads, lr=smoke.LR, weight_decay=smoke.WD))
    lcfg = smoke.LLAMA_F32
    lp = init_llama(1, dtype=torch.float32, device="cuda", max_len=smoke.TRAIN_F32_BATCH[1],
                    **lcfg)
    ltok = smoke.train_batch(lcfg["vocab"], smoke.TRAIN_F32_BATCH, 2)
    loss = smoke.llama_loss(lcfg, memory_budget_bytes=None)
    static = {k: lp[k] for k in ("rope_cos", "rope_sin") if k in lp}
    trained = {k: v for k, v in lp.items() if k not in static}
    res["llama_loss_grad_ms"] = step_ms(lambda: smoke.loss_and_grads(
        trained, ltok, lambda p, t, plain: loss({**p, **static}, t, plain), plain=False))
    return res


def _timed_graph(smoke, fns, host=()) -> dict:
    """``_timed``, 20 calls in a CUDA graph, and the host's work a call
    (chip_smoke.py's ``host_us``: 100 calls enqueued, no sync before the
    clock stops) for each of ``fns`` and for the further ``host`` ({name:
    fn}, timed on the host alone)."""
    res = _timed(smoke, fns)
    for name, fn in fns.items():
        res[f"{name}_graph_ms"] = smoke.cuda_graph_ms(fn)
    for name, fn in {**fns, **dict(host)}.items():
        res[f"{name}_host_us"] = smoke.host_us(fn)
    return res


def _routes(fn) -> bool:
    """Whether this tree's ``fn`` takes ``route=`` (the parent's may not)."""
    import inspect

    return "route" in inspect.signature(fn).parameters


def paged(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.paged_attention import (paged_attention, paged_window_attention,
                                                     quantize_kv)

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    slots, H, hd, ps, pages = 8, 16, 128, 64, 16
    Hq, Hkv, W = smoke.LLAMA["n_heads"], smoke.LLAMA["n_kv_heads"], smoke.SPEC_GAMMA + 1
    P = slots * pages + 1
    tables = torch.randperm(P - 1, generator=g, device="cuda")[:slots * pages]
    tables = tables.reshape(slots, pages).int().contiguous()
    lengths = torch.linspace(0, pages * ps, slots, device="cuda").int()
    lengths_w = torch.linspace(W, pages * ps + 2, slots, device="cuda").int()
    kp, vp = rnd(P, H, ps, hd), rnd(P, H, ps, hd)
    kpi, ksi = quantize_kv(rnd(P, Hkv, ps, hd))
    vpi, vsi = quantize_kv(rnd(P, Hkv, ps, hd))
    q, qi, qw, qwi = rnd(slots, H, hd), rnd(slots, Hq, hd), rnd(slots, W, H, hd), rnd(
        slots, W, Hq, hd)
    i8 = dict(k_scale=ksi, v_scale=vsi)
    host = {}
    if _routes(paged_attention):  # the classic kernels' wrappers, for the host's share
        host = {"decode_bf16_classic": lambda: paged_attention(q, kp, vp, tables, lengths,
                                                               route="classic"),
                "verify_bf16_classic": lambda: paged_window_attention(
                    qw, kp, vp, tables, lengths_w, route="classic")}
    return _timed_graph(smoke, {
        "decode_bf16": lambda: paged_attention(q, kp, vp, tables, lengths),
        "decode_int8": lambda: paged_attention(qi, kpi, vpi, tables, lengths, **i8),
        "verify_bf16": lambda: paged_window_attention(qw, kp, vp, tables, lengths_w),
        "verify_int8": lambda: paged_window_attention(qwi, kpi, vpi, tables, lengths_w, **i8)},
        host)


def norm(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.norm import layer_norm, rms_norm

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    width = smoke.LLAMA["d_model"]
    x, gam, bet = rnd(4096, 2048), rnd(2048), rnd(2048)
    xr, xd, gr = rnd(4096, width), rnd(8, width), rnd(width)
    return _timed_graph(smoke, {
        "layer_4096x2048": lambda: layer_norm(x, gam, bet),
        f"rms_4096x{width}": lambda: rms_norm(xr, gr),
        f"rms_8x{width}": lambda: rms_norm(xd, gr)})


def softmax(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.vector_math import softmax as row_softmax

    g = torch.Generator(device="cuda").manual_seed(5)
    c1 = torch.randn(smoke.CNN_BATCH, smoke.CNN["num_classes"], generator=g, device="cuda") * 4
    bench = torch.randn(8192, 4096, generator=g, device="cuda") * 4
    return _timed_graph(smoke, {
        "c1": lambda: row_softmax(c1), "bench": lambda: row_softmax(bench),
        "torch_c1": lambda: torch.softmax(c1, -1), "torch_bench": lambda: torch.softmax(bench, -1)})


def sgd(smoke) -> dict:
    import torch

    from laser_tpu_torch.models.transformer import init_transformer
    from laser_tpu_torch.ops import optim

    params = init_transformer(0, dtype=torch.bfloat16, device="cuda", **smoke.MODEL)
    g = torch.Generator(device="cuda").manual_seed(0)
    grads = optim.tree_map(lambda p: (torch.randn(p.shape, generator=g, device="cuda")
                                      * 1e-3).to(p.dtype), params)
    mom = optim.tree_map(torch.zeros_like, params)
    lr = torch.tensor(smoke.LR, device="cuda")
    fns = {"sgd": lambda: optim.sgd_momentum_step(params, grads, mom, lr=lr, backend="pallas"),
           "nesterov": lambda: optim.sgd_momentum_step(params, grads, mom, lr=lr, nesterov=True,
                                                       backend="pallas"),
           "torch_sgd": smoke._torch_optimizer(params, grads, "sgd")[0],
           "torch_nesterov": smoke._torch_optimizer(params, grads, "sgd_nesterov")[0]}
    res = _timed(smoke, fns)
    for name, fn in fns.items():
        res[f"{name}_host_us"] = smoke.host_us(fn, n=20)
    return res


def int_gemm(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.gemm import f64_kernel, int32_kernel, int64_kernel, limb_kernel
    from laser_tpu_torch.ops.gemm.api import gemm

    g = torch.Generator(device="cuda").manual_seed(15)
    n, m = 4096, 2048
    a8, b8 = (torch.randint(-8, 8, (n, n), generator=g, device="cuda", dtype=torch.int8)
              for _ in range(2))
    a32, b32 = (torch.randint(-1000, 1000, (m, m), generator=g, device="cuda",
                              dtype=torch.int32) for _ in range(2))
    la, lb = int32_kernel.int32_limbs(a32), int32_kernel.int32_limbs(b32)
    a64, b64 = (torch.randint(-2**63, 2**63 - 1, (m, m), generator=g, device="cuda",
                              dtype=torch.int64) for _ in range(2))
    da, db = int64_kernel.int64_limbs(a64), int64_kernel.int64_limbs(b64)
    af, bf = (torch.randn(m, m, generator=g, device="cuda", dtype=torch.float64) * torch.exp2(
        torch.randint(-30, 30, (m, m), generator=g, device="cuda").double()) for _ in range(2))
    limbs = lambda: limb_kernel.gemm_limbs(da, db, 8)  # noqa: E731
    int32 = lambda: int32_kernel.gemm_int32_limbs(la, lb)  # noqa: E731
    limbs_kernel, int32_kernel_alone = limbs, int32
    if hasattr(limb_kernel, "gemm_limbs_kmajor"):
        dbt, lbt = db.transpose(1, 2).contiguous(), lb.transpose(1, 2).contiguous()
        limbs_kernel = lambda: limb_kernel.gemm_limbs_kmajor(da, dbt, 8)  # noqa: E731
        int32_kernel_alone = lambda: int32_kernel.gemm_int32_limbs_kmajor(la, lbt)  # noqa: E731
    from laser_tpu_torch.ops.gemm import gemm_packed, gemm_prepack_a, gemm_prepack_b

    pa8, pb8 = gemm_prepack_a(a8, n_hint=n), gemm_prepack_b(b8, m_hint=n)
    b8_cols = b8.t().contiguous().t()
    return _timed(smoke, {
        "limbs": limbs, "limbs_kernel": limbs_kernel, "int32": int32,
        "int32_kernel": int32_kernel_alone, "int8": lambda: gemm(a8, b8),
        "f64": lambda: f64_kernel.gemm_f64(af, bf, slices=8),
        "packed_int8": lambda: gemm_packed(1, pa8, pb8),
        "torch_int_mm_tn": lambda: torch._int_mm(a8, b8_cols)})


def _host_ops_us(name, fn, n: int = 200) -> dict:
    """CPU self time a call of ``fn`` spends in each torch operator
    (torch.profiler's CPU events over ``n`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {f"split_{name}_{e.key.removeprefix('aten::')}_us": e.self_cpu_time_total / n
            for e in prof.key_averages() if e.key.startswith("aten::")}


def staged(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops import reductions as R

    g = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(8192, 8192, generator=g, device="cuda") * 3 + 1
    flat = x.flatten()
    fns = {"mean_var": lambda: R.mean_var(x), "argmax": lambda: R.argmax(x),
           "argmin": lambda: R.argmin(x),
           "torch_var_mean": lambda: torch.var_mean(x, correction=0),
           "torch_max": lambda: torch.max(flat, 0), "torch_min": lambda: torch.min(flat, 0)}
    if _routes(R.mean_var):
        fns.update({f"classic_{f}": (lambda f=f: getattr(R, f)(x, route="classic"))
                    for f in ("mean_var", "argmax", "argmin")})
    res = _timed_graph(smoke, fns)
    res.update(_host_ops_us("mean_var", fns["mean_var"]))
    if "classic_mean_var" in fns:
        res.update(_host_ops_us("classic_mean_var", fns["classic_mean_var"]))
    return res


def _cold_graphs(smoke, fns) -> dict:
    """20 calls in a CUDA graph, each ({name: (fn, items)}) on the next of
    its inputs (copies whose bytes together exceed L2)."""
    return {f"{name}_cold_graph_ms": smoke.cuda_graph_ms(smoke.rotating(fn, items))
            for name, (fn, items) in fns.items()}


def _python_us(res: dict, name: str) -> None:
    """What the torch operators (``split_<name>_*``) leave of a call's host
    time."""
    ops = sum(v for k, v in res.items() if k.startswith(f"split_{name}_"))
    res[f"{name}_python_us"] = res[f"{name}_host_us"] - ops


_SCALE = 2.0


def _scaled(p):
    return p * _SCALE


def strided(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops import foreach as fe
    from laser_tpu_torch.ops import strided as S
    from laser_tpu_torch.ops import vector_math as vm
    from laser_tpu_torch.tensor import TensorView

    g = torch.Generator(device="cuda").manual_seed(14)
    M, C = 16384, 4096
    bufs = [torch.randn(M, C, generator=g, device="cuda") for _ in range(2)]
    two = lambda p: p * 2.0  # noqa: E731

    def view(x):
        return TensorView(x.reshape(-1), (M // 2, C), (2 * C, 1), C)

    def every2(x):
        return x[1::2]

    cases = {"view": view, "every2row": every2}
    fns, cold = {}, {}
    routes = [None] + (["classic"] if _routes(S.strided_for_each) else [])
    for route in routes:
        for name, make in cases.items():
            key = f"classic_{name}" if route else name
            if route:
                def run(v, route=route):
                    return S.strided_for_each(two, [v], route=route)
            else:
                def run(v):
                    return fe.for_each(two, v)
            fns[key] = (lambda run=run, v=make(bufs[0]): run(v))
            cold[key] = (run, [(make(b),) for b in bufs])
    fns["torch_every2row"] = lambda: bufs[0][1::2] * 2.0
    cold["torch_every2row"] = (lambda x: x[1::2] * 2.0, [(b,) for b in bufs])
    # bodies that read more than their operand, on the route the tree picks
    # over x[1::2]: a module global, the package's accurate exp and a global,
    # and a Python function of the caller's (which reads a global)
    bodies = {"global": lambda p: p * _SCALE, "exp_acc": lambda p: vm.exp_acc(p) * _SCALE,
              "helper": lambda p: _scaled(p) - 1.0}
    for name, body in bodies.items():
        fns[f"body_{name}"] = lambda body=body, v=bufs[0][1::2]: fe.for_each(body, v)
    res = _timed_graph(smoke, fns)
    res.update(_cold_graphs(smoke, cold))
    for name in fns:
        res.update(_host_ops_us(name, fns[name]))
        _python_us(res, name)
    return res


def online_softmax(smoke) -> dict:
    import torch

    from laser_tpu_torch.ops.vector_math import softmax_online

    g = torch.Generator(device="cuda").manual_seed(5)
    rows, cols = 64, 128256
    fns, cold = {}, {}
    routes = [None] + (["classic"] if _routes(softmax_online) else [])
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        copies = smoke.cold_copies(
            lambda: (torch.randn(rows, cols, generator=g, device="cuda") * 4).to(dt),
            2 * rows * cols * torch.empty((), dtype=dt).element_size())
        x = copies[0]
        for route in routes:
            key = f"classic_{tag}" if route else tag
            run = (lambda c, route=route: softmax_online(c, route=route)) if route else \
                softmax_online
            fns[key] = lambda run=run, x=x: run(x)
            cold[key] = (run, [(c,) for c in copies])
        fns[f"torch_{tag}"] = lambda x=x: torch.softmax(x, -1)
        cold[f"torch_{tag}"] = (lambda c: torch.softmax(c, -1), [(c,) for c in copies])
    res = _timed_graph(smoke, fns)
    res.update(_cold_graphs(smoke, cold))
    return res


def primitives(smoke) -> dict:
    from laser_tpu_torch import registry

    registry.load_generated_many(smoke.prim_sources())
    return {f"{c.name}/{c.slot or 'main'}": smoke.cuda_ms(c.time_run or c.run,
                                                         reps=smoke.PRIM_REPS)
            for c in smoke.prim_cases()}


BENCHES = {"flash_forward": flash_forward, "flash_backward": flash_backward,
           "serving": serving, "cnn": cnn, "conv": conv, "wgmma_gemm": wgmma_gemm,
           "paged": paged, "norm": norm, "primitives": primitives, "f32_gemm": f32_gemm,
           "int_gemm": int_gemm, "softmax": softmax, "sgd": sgd, "staged": staged,
           "strided": strided, "online_softmax": online_softmax}


def _time_tree(bench: str, tree: str) -> dict:
    sys.path.insert(0, tree)
    import laser_tpu_torch
    from laser_tpu_torch import registry

    pkg = os.path.realpath(os.path.dirname(laser_tpu_torch.__file__))
    if not pkg.startswith(os.path.realpath(tree) + os.sep):
        raise SystemExit(f"imported {pkg}, not the package under {tree}")
    registry.load_library()
    return {"tree": tree, "bench": bench, **BENCHES[bench](_chip_smoke())}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(_time_tree(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) != 4 or sys.argv[1] not in BENCHES:
        print(__doc__, file=sys.stderr)
        return 2
    bench = sys.argv[1]
    a, b = (os.path.abspath(t) for t in sys.argv[2:])
    for tree in (a, b, b, a):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", bench, tree],
                            cwd=tree).returncode
        if rc:
            return rc
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
