#!/usr/bin/env python3
"""Drive laser_tpu_torch's serving, training, CNN, primitives, layout, GEMM
dtype table, library and Llama training paths on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and the result line is not
printed:

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from laser_tpu_torch/csrc (one nvcc per source, in parallel;
   timed).
2. Each kernel at the full-width shapes its paths give it, and once at a
   small f32 shape: compare it with its plain PyTorch version on the card
   against a stated bound, and time the kernel, the plain version and,
   where one PyTorch call computes the same function, that call
   (``library_ms``; the port never calls it), with CUDA events (the kernel
   also as 20 calls in a row, ``batched_ms``: its device time where the
   host enqueues faster than the kernel runs). Each timed
   case also gets ``bound_ms``, the least time the card could take for the
   same work, from its bytes and operations at the peak rate of its input
   type; the library call is also timed 20 in a row (once for all the
   cases that race it: the two flash backward kernels share one). The serving and
   training kernels run in bf16; beside the transformer shapes: the flash
   kernel's GQA map and the paged kernel over int8 pages at the Llama-3-8B
   widths. The 16-bit GEMM, the bf16 flash forward and the bf16 flash
   backward run on their Hopper routes (``gemm_wgmma``: wgmma fed by a TMA
   ring; ``flash_attention_mma``, ``flash_attention_bwd_dq_mma`` and
   ``flash_attention_bwd_dkv_mma``: mma.sync on the tensor cores), and the
   kernels they replace at the same shapes, asked for by ``route=``
   (``gemm``: WMMA; ``flash_attention``, ``flash_attention_bwd_dq``,
   ``flash_attention_bwd_dkv``: FFMA), each case asserting that its route's
   counter moved; the backward also at a ragged S 1030, D 64. Paged
   attention's decode (row 4) and verify (row 5) run on the split route
   (``paged_attention_split``, ``paged_window_attention_split``: one
   tensor-core skeleton split over the keys) and on the classic kernels
   asked for, over bf16 pages and int8 pages at the Llama widths, each with
   SDPA with the key (or causal window) mask on K/V gathered beforehand as
   its library call and also as 20 calls in a CUDA graph, warm and over
   copies of the pools past L2; the split route's decode at W 1 must give
   the verify's bits, and each two calls the same bits. The layer norm
   (4096 x 2048) and the RMS norm at the Llama width (4096 and 8 rows of
   4096) run on the vec route (``norm_vec``: the row in registers) and on
   the classic kernel asked for, gains in bf16, beside ``F.layer_norm`` /
   ``F.rms_norm``, also in a CUDA graph (the 4096 rows also over copies of
   x past L2). The
   weight-streaming products run on the routes the library picks: the
   decode GEMM (M 8) and the verify's (M 40) on split-K (``gemm_splitk``),
   the Llama-3-8B decode products (K4096 N14336, K14336 N4096) bf16 on
   split-K and int4 on the stream route (``w4_gemm_stream``), the int4
   prefill (M4096 K4096 N14336) on the mma route (``w4_gemm_mma``), C1's
   head (f32 M16 K50176 N128) on split-K; the decode GEMM, C1's head and
   both int4 shapes also on the classic kernels asked for. These are also
   timed as 20 calls captured in a CUDA graph (``graph_ms``, and the
   library call's ``library_graph_ms``): the device's time for calls
   shorter than the wrapper's host work, with the weight warm in L2; the
   decode products also over copies of their weight that exceed L2 (100
   MB), each call on the next (``cold_graph_ms``, ``library_cold_graph_ms``),
   as a decode step finds them. Then every route asked for at M 1
   to 128 of the decode product, Llama's w_down and the transformer's w2
   (bf16: split-K up to 64 rows, wgmma, WMMA), at M 16 to 256 of the
   decode product in f32 (split-K up to 64 rows, simt, FFMA), of an int8
   4096 x 4096 weight (wgmma on B row-major and on B K-major, WMMA) and of
   Llama's int4 w_gate (stream up to 64 rows, mma, WMMA), 20 calls in a
   CUDA graph each: the crossovers behind the launchers' M thresholds.
   Row 1's f32 product, Lux's relu(a @ b + bias) at M4096 K2048 N2048, runs
   on the route the library picks (``gemm_simt``: the FFMA skeleton of
   csrc/simt_gemm.cuh) and on the classic FFMA kernel asked for
   (``gemm``), the two held to the same bits and timed beside
   ``torch.relu(torch.addmm(...))`` with TF32 off and the FFMA bound. The
   CNN path's kernels run in f32 at C1's
   shapes (the planewise conv at conv 1, the direct conv's ffma route at
   convs 2 and 3, the (16, 1000) softmax), with conv 3 also in bf16 (the
   mma route) and at stride 2 (one launch of either route), each direct
   case also on the classic kernels asked for in the same run (at stride 2
   laser_tpu's phase convs, ``conv2d_direct(..., route="classic")``), the
   row softmax at 16 x 1000 and 8192 x 4096 in f32 and bf16 on the route
   the library picks (``softmax_vec``: the row in registers) and on the
   classic kernel asked for (``softmax``), the 16 x 1000 cases also in a
   CUDA graph and as host microseconds a call (``host_us``: 100 calls
   enqueued, no sync before the clock stops), and the online softmax at 64
   x 128256 (Llama-3's vocabulary) in f32 and bf16 on the cluster kernel
   (``softmax_online_cluster``) and on the classic online kernel asked for
   (``softmax_online``), also in a CUDA graph, in a graph over copies of
   the rows past L2 (cold) and as host microseconds a call, each element
   within its stated bar of the plain version; the library is cuDNN (TF32
   off) or ``torch.softmax``.
3. The serving slice: ServingEngine over the 8-layer d2048 bf16 transformer
   with random weights from a seed, 12 greedy requests through 8 slots.
   Checks token counts and range, that every serving kernel launched and no
   plain version ran, the first-token logits of two requests against the
   plain dense forward, and prints the token agreement with the plain
   greedy_decode. One more engine run under torch.profiler: device time by
   kernel and the device's idle share.
4. The same engine at 2 layers d512 in f32: its tokens must equal the plain
   f32 greedy_decode for every request.
5. The training slice: ``transformer_train_step`` on the same 8-layer d2048
   bf16 model, batch 8 x 1024 from RandomState(0). First the step-1 loss
   and every gradient leaf against the ``plain=True`` route (autograd of
   the plain versions). Then the path itself, counted: a value-only eval
   loss, step 1 (warm-up), steps 2-6 (timed), the eval loss again; every
   training kernel launched, no plain version ran, the eval loss fell.
   Then one more step under torch.profiler: device time by kernel and the
   device's idle share.
6. f32 exactness: 2 layers d512, 4 heads, vocab 8192, batch 4 x 256, TF32
   off: loss and gradients through the kernels against ``plain=True``, and
   one train step each, with an Adam-aware bound on the updated params.
7. Llama serving at the Llama-3-8B widths (d_model 4096, 32 query heads
   over 8 kv heads of 128, d_ff 14336, vocab 128256, rope base 500000),
   depth cut to 8 layers, bf16, random weights from a seed; phase 3's
   traffic and engine config. Run (a) unquantized, run (b) with int4 block
   weights (group 64) and int8 KV pages. Each run checks its tokens, that
   every kernel of its path launched and no plain version ran, and the
   first-token logits of two requests against the plain dense
   ``llama_forward`` (on the dequantized weights in (b)); prints tokens/s,
   the weight bytes and the token agreement with the plain bf16
   ``llama_generate`` on the same (dequantized) weights, and in (b) with
   (a), then profiles one more run.
8. Llama f32 exactness at 2 layers d512, 8 heads over 2 kv heads, TF32 off:
   the engine's tokens equal the plain ``llama_generate``'s for every
   request, unquantized and with int4 weights (against the dequantized
   weights); with int8 KV pages the first tokens are equal.
9. Speculative serving, run S1 (laser_tpu's ``serving_spec_weightbound``
   row, bench.py:950-985): phase 3's model, 8 prompts of 128 tokens, 256
   new tokens each, greedy, decode bursts of 64, pipelined; the plain burst
   engine, then the int8 quantized self-draft at gamma 4. Checks tokens and
   that every kernel of each run launched with no plain version (the window
   kernel in the speculative run); prints tokens/s, the acceptance alpha,
   the speed ratio, the token agreement with the plain burst engine, and
   the profile of one more run of each engine (64 new tokens per request).
10. Run S2: phase 7's model, traffic and engine config with int8 pages,
   bursts of 20, pipelined; the plain burst engine, then the int4
   quantized self-draft at gamma 4 (``w4_gemm`` in the draft, the window
   kernel's int8 variant in the verify). The same checks and prints (the
   profiled runs with 16 new tokens per request).
11. f32 speculation at phases 4 and 8's widths, TF32 off: the speculative
   engine's tokens equal the plain engine's and the dense reference's
   (``greedy_decode``, ``llama_generate``) for every request, with a
   self-draft, a smaller different draft and an int4 self-draft; with int8
   pages and pipelining, equal to the plain engine's on the same pages.

12. The CNN slice, configuration C1: ``init_cnn`` with convs 3->20->64->64
   at 224x224 (pooled 2x2 after each), head 50176->128->1000, f32, random
   weights from a seed; ``cnn_predict`` on 16 images from a seed. Checks the
   launches per forward (planewise conv 1, the direct conv's ffma route 2,
   gemm 2, softmax_vec 1, nothing else, no plain call), that each row of probabilities sums to 1
   within 1e-5, and the logits within 1e-4 (of max) of the ``plain=True``
   route and of the same forward on cuDNN/cuBLAS with TF32 off, argmax
   identical; prints images/s of both (median of 20 synchronised forwards)
   and the profile of 10 forwards, with the share of their device kernels
   the trace kept. Then ``mlp_predict`` over [50176, 128,
   1000] on the conv trunk's flattened features: rows sum to 1, gemm and
   softmax launched.

13. The primitives path at bench.py's shapes (bench.py:293-337, 390-399), f32
   unless stated: exp (accurate and fast, donated), log / tanh / sigmoid
   (fast) on 8192 x 8192; for_each of x + y - sin z (donated) and
   for_each_multi (x + y, x - y) on 4096 x 4096; reduce_sum and map_reduce
   with a combine_fn outside the vocabulary (per-block partials, combined in
   torch) on 8192 x 8192; row_reduce(exp, sum) on 8192 x 4096; Lux
   a + b - lux_sin(c), lux_sum(a * b, axis=-1) and relu(a @ b + bias)
   (M4096 K2048 N2048, the GEMM kernel's epilogue); bf16 for_each and exp on
   8192 x 8192. The bodies' generated sources are built first, one nvcc
   each, all at once (printed: count and seconds). Then the path runs once
   with the counts at 0: for_each, for_each_multi, row_reduce and map_reduce
   must have launched and no plain version run; a profile of three more
   runs (a late profiler session may drop its first ~18 launches).
   Each case is then held against its plain version on the same tensors
   (bounds in PRIM_*: the accurate-tier exp bit for bit, other f32 values
   1e-6, the fast tier 2e-5 and bf16 2^-7, each element against
   max(|plain|, 1); sums 1e-6 of sum |mapped|), each reduction run twice
   must give the same
   bits, and the kernel, the plain version and the library call are timed
   (median of 20 CUDA-event calls, 5 for plain) beside the bound, the
   kernel also as 20 calls in a row between two events (its device time).

14. The layout and strided primitives at bench.py's shapes (bench.py:339-413),
   f32 unless stated, nothing cut: for_each(p * 2) over every second row of
   16384 x 4096 as a TensorView (offset 4096) and as x[1::2] (the tiled
   strided kernel, ``for_each_strided_tiled``); transpose2d
   of 8192^2 out of place (f32 and bf16) and in place (donate=True);
   nchw2nhwc / nhwc2nchw at C1's conv-3 activation 16 x 64 x 56 x 56;
   mean_var, argmax and argmin of 8192^2 and a custom map_reduce_staged
   body (count of positives, sum of negatives); beside them odd shapes: a
   1 x 1 and a 100 x 37 transpose, in place at N 128 and 384, 1-D strided,
   negative-stride and transposed views, argmax with its maximum twice.
   The 5 generated bodies are built first, in parallel. The path runs once
   with the counts at 0 (launches by path "layout"; all four kernels must
   launch, the staged reductions on the one launch,
   ``map_reduce_staged_one``, and the two-launch template
   ``map_reduce_staged`` not at all, the strided views on the tiled kernel
   and the classic ``for_each_strided`` not at all; no plain version run),
   then three times under the profiler. Outside that count mean_var, argmax
   and argmin run again on the two-launch template asked for
   (``route="classic"``), and the five strided views on the classic strided
   kernel (``strided_for_each(..., route="classic")``). Each case is
   held against its plain version on the same card tensors: transposes and
   the strided body bit for bit, mean_var within 1e-5 of float64 and of
   plain, arg-reductions equal to numpy's, reductions bit-identical on two
   runs; then timed as in phase 13 (kernel, 20 in a row, plain, library,
   bound), and mean_var, argmax and argmin on both routes, the five
   strided cases on both routes, and their torch calls also as 20 calls in
   a CUDA graph (where the default staged route runs the two-launch
   template; a 16384 x 4096 strided call moves 268 MB, past L2) and as the
   host's microseconds a call.

15. The GEMM dtype table at bench.py's shapes and data (bench.py:128-273)
   and BASELINE.json's batched GEMM: ``gemm`` int8 4096^3 (randint(-8, 8))
   -> int32 (the int8 wgmma route, B copied K-major first: a transpose
   launch); ``gemm`` int32 2048^3 (randint(-1000, 1000)), the kernel timed on
   pre-split limbs (B's K-major); the limb kernel on the 8 digit planes of
   full-range int64 2048^3 and ``gemm`` int64 end to end; ``gemm_f64``
   2048^3 (randn * 2^[-30, 30)) at 8 and 4 slices and the limb kernel on
   its digits; ``gemm_batched`` bf16 B4 4096^3 (the wgmma route);
   ``quantize_int8`` of 4096^2 f32 per row, global and stochastic;
   ``gemm_quantized`` 4096^3 f32. The path runs once with the counts at 0
   (launches by path "gemm_table"; gemm_i8_wgmma, gemm_batched_wgmma,
   gemm_int32_wgmma, gemm_limbs_wgmma, quantize_int8 and transpose (the
   int8 product's copy of B) must launch, and
   the WMMA kernels they replace, gemm, gemm_int32 and gemm_limbs, must
   not; no plain version run). Outside that count, as yardsticks beside
   it: each replaced WMMA kernel on the same inputs (``route="classic"``:
   the int8 GEMM, the int32 kernel and the limb kernel on the int64 and
   f64 digits, B's K-major, the batched product), the int8 product on a K-major B (no
   copy) against ``torch._int_mm`` in cuBLASLt's native TN layout, the
   public ``gemm_limbs`` on (8, K, N) planes (one K-major copy in the
   call) and the K-major copies alone (csrc/transpose.cu's 1-byte
   kernel), each checked and timed. Integer results and quantization are
   held to their plain versions bit for bit, each integer plain version's
   64 x 64 corner to an exact integer oracle on the host and int8 also to
   ``torch._int_mm``; f64 within 1e-15 of plain and 2^-50 (8 slices) or
   2^-24 (4) of cuBLAS DGEMM, relative to K rowmax|a| colmax|b|; bf16
   batched within 2^-7; then timed as in phase 13, the bound at the rate
   of the work's type (int8 1979 TOP/s, f64 67 TFLOP/s, bf16 989). Then
   ``gemm`` int64 and ``gemm_f64`` (8 slices) run under torch.profiler:
   the device time of the limb kernel against the digit split and the
   combine. It also prints what torch.matmul does with CUDA int32 and
   int64.

16. The library surface at full size, path "library": the card's name and
   power limit; ``adamw_step(backend="pallas")`` at steps 1 (weight decay
   0.0) and 3 (0.1) and ``sgd_momentum_step(backend="pallas")`` without and
   with Nesterov, over phase 5's 8L d2048 bf16 tree and the gradients of
   one ``value_and_grad`` of its loss on phase 5's batch, lr a 0-d CUDA
   tensor; ``stencil_solve`` red-black and Jacobi on 1024^2 f32 (randn,
   seed 0), f = 0, 100 iterations (bench.py:576-610); ``gemm_packed`` bf16
   and f32 at 4096^3 (randn * 0.05, alpha 0.05, bench.py:54-63) with B
   packed once and 4 different A (bf16 on the wgmma route, f32 on the
   simt route), and the packed int8 product at 4096^3 (randint(-8, 8),
   alpha 1, B packed once; the int8 wgmma route, ``gemm_packed_i8_wgmma``,
   on B's K-major twin). SGD runs on the multi-tensor kernel
   (``sgdm_multi``: one launch for the tree's one dtype), AdamW one launch
   a leaf. The path runs once with the counts at 0 (all six kernels must
   launch, the classic ``gemm_packed`` not at all; no plain version run).
   Outside that count f32 runs once more on the classic kernels asked for
   (the simt route's bits), bf16 and int8 too, and SGD on the per-leaf
   kernel asked for (``sgdm_update``, 99 launches a step), each checked
   and timed beside its route. The updates and the stencil are held to their plain
   versions bit for bit, the int8 product to its plain version and to
   ``torch._int_mm`` bit for bit, the float packed products to the plain
   version and to torch.matmul on the unpacked operands (bf16 2^-7, f32
   1e-5 of max), the card's packed bytes to a CPU pack; a 16^2 grid with
   zero edges converges (interior < 1e-4 after 500 red-black iterations).
   Then timed as in phase 13, with the default backends, torch.optim's
   fused AdamW / SGD (plain and Nesterov), ``torch._int_mm`` (B
   column-major) and torch.matmul as library calls, the stencil's sweeps/s,
   effective GB/s and streaming bound, and the packing times (int8: B's
   K-major twin alone, ms and bytes); one call of
   each update under the profiler (device ms; SGD's one launch a step
   over 50 steps) and the SGD steps' host microseconds.

17. Llama training at phase 7's widths (Llama-3-8B: d_model 4096, 32
   query heads over 8 kv heads of 128, d_ff 14336, vocab 128256, rope base
   500000), depth cut to 8 of 32 layers, bf16, random weights from a seed;
   one batch of 4 x 1024 tokens from RandomState(0): 4092 target rows, so
   ``lm_cross_entropy`` takes its chunked branch (2 x 4092 x 128256 x 2 B
   past the 1 GiB budget). First the step-1 loss and every gradient leaf
   against the ``plain=True`` route (phase 5's bounds). Then the path,
   counted (path "llama_train"): a value-only eval loss, 6
   ``llama_train_step``s (median of steps 2-6 timed), the eval loss again;
   every kernel of the path launched (``ce_bwd`` through the vocabulary
   chunks), no plain version ran, the eval loss fell. One ``remat=True``
   step at lr 0 (the weights stay), then one step without remat from the
   same weights under torch.profiler: equal losses within phase 5's loss
   bound, one more flash forward and two more norms a block with remat;
   device time by kernel and the idle share. Last, ``llama_train_step_mp``
   (a bf16 compute tree, fp32 masters and moments) at the same widths cut
   to 4 layers: its loss finite and equal to the value-only loss of the
   same bf16 weights within the bound, the weights moved. Prints training
   tokens/s, step ms and peak memory.

Phase 2 also holds ``ce_bwd`` (row 9) against ``ce_bwd_plain`` (bf16 within
2^-7 of max, f32 1e-6) at T 2048 x V 256000 (``google/gemma-7b``'s
vocabulary: the loss alone, no model) in bf16 and f32 with eps 0 and 0.1,
and on two f32 chunks of phase 17's loss (T 4092 at column 3 x 8192 of
the Llama-3 vocabulary, and its ragged last 5376 columns), its library
call the backward alone of ``F.cross_entropy``. Phase 6 has a llama
companion: 2 layers, d512, 8 query heads over 2 kv heads, vocab 8192,
``memory_budget_bytes=None`` (the chunked branch), f32, TF32 off, its loss
and gradients through the kernels against ``plain=True``.

Phase 2 also runs each kernel of phases 15 and 16 once at a small odd
shape against its plain version (bit for bit but for the packed float
products; the f32 simt route also bit for bit against the classic
kernels), and holds the paged window (verify)
kernel against its plain version: bf16 at run S1's shape, int8 pages at the Llama widths, and f32,
each output row against its own size, with one window ending past its
table. The profiles record device activity only.

The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record, and the line before that the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

# stated bounds: max |kernel - plain| / max |plain|, per output dtype. bf16
# outputs round to 8 mantissa bits, so two correct fp32-accumulating paths
# that sum in different orders may differ by one bf16 ulp of the largest
# value (2^-7 relative); f32 differs only by summation order.
REL_BOUND = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# first-token logits of the full bf16 model, engine vs plain dense forward:
# the two paths round different intermediates to bf16 through 8 layers
LOGITS_REL_BOUND = 5e-2
# full-width bf16 training, kernel route vs plain route, step-1 loss and each
# gradient leaf as ||a - b|| / ||b||: the routes round to bf16 at different
# points (z before the activation; P before P.V in the forward, which the
# plain route also differentiates through) and the gradients pass through 8
# layers of bf16 products in both directions. The loss sees those roundings
# once, averaged over 8184 rows; the worst leaf (a layer-norm gain, a sum
# over all rows) carries them most
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL = 5e-2
# f32 training, kernel route vs plain route: summation order only
F32_LOSS_REL, F32_GRAD_REL = 1e-5, 1e-4

MODEL = dict(n_layers=8, d_model=2048, n_heads=16, d_ff=8192, vocab=8192)
MODEL_F32 = dict(n_layers=2, d_model=512, n_heads=4, d_ff=2048, vocab=8192)
# meta-llama/Meta-Llama-3-8B config.json widths, 8 of its 32 layers
LLAMA = dict(n_layers=8, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256)
LLAMA_ROPE = dict(max_len=8192, base=500000.0)
LLAMA_F32 = dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=2, d_ff=1536, vocab=8192)
LLAMA_INT4 = dict(weight_quant="int4", weight_quant_group=64)
N_REQUESTS, NEW_TOKENS = 12, 64
SERVE_CFG = dict(page_size=64, max_seqs=8, max_pages_per_seq=16, n_pages=129,
                 prefill_buckets=(128, 256, 512))
TRAIN_BATCH, TRAIN_F32_BATCH = (8, 1024), (4, 256)
TRAIN_STEPS, LR, WD = 6, 3e-4, 0.01
# bf16 products with M > 40 (prefill) take the wgmma GEMM, the decode
# products (M <= 40) the split-K route; bf16 flash at D 128 the tensor cores
SERVING_KERNELS = ("gemm_splitk", "gemm_wgmma", "norm_vec", "flash_attention_mma",
                   "paged_attention_split")
# runs S1 and S2: the plain burst engine, then the quantized self-draft
SPEC_GAMMA = 4
S1_CFG = dict(page_size=64, n_pages=8 * 7 + 2, max_seqs=8, max_pages_per_seq=7,
              prefill_buckets=(128,), decode_burst=64, pipeline_bursts=True)
S1_TRAFFIC = dict(n=8, prompt=128, new=256)
S2_CFG = dict(SERVE_CFG, kv_quant=True, decode_burst=20, pipeline_bursts=True)
SPEC_KERNELS = {"s1_plain": SERVING_KERNELS,
                "s1_spec": SERVING_KERNELS + ("paged_window_attention_split",),
                "s2_plain": SERVING_KERNELS,
                "s2_spec": SERVING_KERNELS + ("w4_gemm_stream", "paged_window_attention_split")}
SPEC_F32_CFG = dict(SERVE_CFG, decode_burst=20, pipeline_bursts=True)
DRAFT_F32 = dict(n_layers=1, d_model=256, n_heads=2, d_ff=512, vocab=8192)
LLAMA_DRAFT_F32 = dict(n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=8192)
# bf16 at D 128: the flash forward and backward on the tensor cores
TRAINING_KERNELS = ("gemm_wgmma", "norm_vec", "flash_attention_mma", "flash_attention_bwd_dq_mma",
                    "flash_attention_bwd_dkv_mma", "ce_fused_grad", "ce_fwd")
# Llama training (phase 17): phase 7's widths and rope, batch 4 x 1024; the
# loss's chunked branch runs ce_bwd and no other CE kernel
LLAMA_TRAIN_BATCH = (4, 1024)
LLAMA_MP_LAYERS = 4
LLAMA_TRAIN_KERNELS = ("gemm_wgmma", "norm_vec", "flash_attention_mma",
                       "flash_attention_bwd_dq_mma", "flash_attention_bwd_dkv_mma", "ce_bwd")
# phase 6's f32 llama loss: the simt GEMM and the FFMA flash kernels
# (forward and backward); the norm's d512 rows take the vec kernel in f32 too
LLAMA_TRAIN_F32_KERNELS = ("gemm_simt", "norm_vec", "flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "ce_bwd")
# ce_bwd against its plain version: f32 exp and the same fp32 arithmetic;
# bf16 dx one rounding of the largest element apart
CE_BWD_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-6}
# run (b)'s block linears are all int4 (decode on the stream route, prefill
# on the mma route) and its logits torch.matmul: no gemm
LLAMA_KERNELS = {"llama": ("gemm_splitk", "gemm_wgmma", "norm_vec", "flash_attention_mma",
                           "paged_attention_split"),
                 "llama_int4": ("w4_gemm_stream", "w4_gemm_mma", "norm_vec",
                                "flash_attention_mma", "paged_attention_split")}
# the CNN slice, C1: laser_tpu's init_cnn with convs at the conv benchmark's
# shapes (bench.py:1061-1108: N16 C3->20 224^2, and 64->64 at 56^2 after two
# pools) and ImageNet-1k's 1000 classes; batch 16, f32
CNN = dict(in_channels=3, conv_channels=(20, 64, 64), hidden=128, num_classes=1000,
           image_hw=224)
CNN_BATCH, CNN_FORWARDS = 16, 20
# launches of each kernel per cnn_predict (every other kernel: none), and
# the device kernels of one forward: these 6, the split-K reduce of each
# head product, and PyTorch's bias add, ReLU and mean pool after each conv
CNN_LAUNCHES = {"conv_planewise": 1, "conv_direct_ffma": 2, "gemm_splitk": 2, "softmax_vec": 1}
CNN_DEVICE_KERNELS = 17
# forwards in the profiled window: a trace late in the script once kept 1
# of one forward's 15 kernels; over 10 a dropped record shows as coverage
CNN_PROFILE_FORWARDS = 10
# f32 logits, kernel route vs the plain route and vs cuDNN with TF32 off:
# summation order only; probabilities sum to 1 within
CNN_LOGITS_REL, PROB_SUM_TOL = 1e-4, 1e-5
DTYPE_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
DEVICE = "cuda"


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_batched_ms(fn, n: int = 20, reps: int = 3) -> float:
    """Milliseconds per call of ``n`` calls between two CUDA events (median
    of ``reps``): the device's time per call wherever the host enqueues
    faster than the kernel runs, which one call between two events hides
    behind the wrapper's host work."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


# bytes of weight copies a cold-cache timing cycles through: twice the
# H100's 50 MB L2
COLD_BYTES = 100e6


def rotating(fn, items):
    """A call of fn(*item) on the next of ``items`` each time."""
    cycle = itertools.cycle(items)
    return lambda: fn(*next(cycle))


def cuda_graph_ms(fn, n: int = 20, reps: int = 3) -> float:
    """Milliseconds per call of ``n`` calls captured in one CUDA graph and
    replayed (median of ``reps``): no host work between the calls, so the
    device's time for calls too short to outrun the host's enqueue."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def host_us(fn, n: int = 100, reps: int = 5) -> float:
    """Host microseconds a call: ``n`` calls enqueued after a sync, on the
    host's clock, with no sync before the clock stops (the card runs
    behind), median of ``reps``: the wrapper's Python and its launches."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def rel_error(got, want, per_row: bool = False):
    """(max abs error, relative error) of ``got`` against ``want``: the
    error over max |want|, or with ``per_row`` each row of the last axis
    over its own max |want| (the worst row), for outputs whose rows differ
    in size by more than the bound, as attention over one key and over a
    thousand do."""
    d = (got.float() - want.float()).abs()
    if per_row:
        rel = (d.amax(-1) / want.float().abs().amax(-1).clamp(min=1e-30)).max().item()
    else:
        rel = d.max().item() / max(want.float().abs().max().item(), 1e-30)
    return d.max().item(), rel


# the online softmax kernels against their plain version, element by element
# (the sums are taken in another order): f32 rtol 1e-5, atol 1e-9; bf16 and
# f16 one unit in the last place, 2^-7 relative, and f16's subnormal unit
ONLINE_TOL = {torch.float32: (1e-5, 1e-9), torch.bfloat16: (2.0 ** -7, 0.0),
              torch.float16: (2.0 ** -7, 2.0 ** -24)}


def compare(name, got, want, per_row: bool = False, rel_bound: Optional[float] = None,
            tol: Optional[tuple] = None):
    """Max abs error of each output against the plain version, its relative
    error (``rel_error``) held to ``rel_bound`` or the bound of its dtype,
    and with ``tol`` = (rtol, atol) every element within rtol |plain| +
    atol; returns the largest abs error."""
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        bound = rel_bound or REL_BOUND[g.dtype if g.dtype != torch.float16 else torch.bfloat16]
        if g.shape != w.shape or not torch.isfinite(g.float()).all():
            fail(f"{name}[{i}]: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite")
        err, rel = rel_error(g, w, per_row)
        print(f"  {name}[{i}]: max_abs_err {err:.3e} rel{' (worst row)' if per_row else ''} "
              f"{rel:.3e} (bound {bound:.0e})", flush=True)
        if not rel <= bound:
            fail(f"{name}[{i}]: relative error {rel:.3e} > {bound:.0e}")
        if tol is not None:
            gd, wd = g.double(), w.double()
            bad = int(((gd - wd).abs() > tol[0] * wd.abs() + tol[1]).sum().item())
            print(f"  {name}[{i}]: {bad} elements past rtol {tol[0]:.3g}, atol {tol[1]:.3g}",
                  flush=True)
            if bad:
                fail(f"{name}[{i}]: {bad} elements past rtol {tol[0]}, atol {tol[1]}")
        worst = max(worst, err)
    return worst


@dataclasses.dataclass
class Case:
    name: str                 # the kernel record
    shape: str
    kern: Callable
    plain: Callable
    flops: float = 0.0        # operations this call's inputs need
    nbytes: float = 0.0       # each input read once, each output written once
    library: Optional[Callable] = None
    library_call: Optional[str] = None
    slot: str = ""            # "" for the kernel's main shape, else a sub-record
    per_row: bool = False     # rel_error per output row
    dtype: torch.dtype = torch.bfloat16  # the input type: the bound's peak rate
    rel: Optional[float] = None  # the comparison's bound, if not REL_BOUND's
    graph: bool = False       # also time it (and the library call) as a CUDA graph
    # (kernel, library) over copies of the inputs (the weight, the pages,
    # the rows) that together exceed the L2 cache, each call on the next:
    # timed as a CUDA graph, the cold cache a serving step finds
    cold: Optional[tuple] = None
    host: bool = False        # also the host's microseconds a call (host_us), kernel and library
    tol: Optional[tuple] = None  # (rtol, atol): also every element within rtol |plain| + atol


def bound(case: Case, spec):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of the input type (989 TFLOP/s bf16/f16,
    67 f32 FFMA)."""
    peak = spec.bf16_tflops if case.dtype in (torch.bfloat16, torch.float16) else spec.f32_tflops
    t_ops = case.flops / (peak * 1e12) * 1e3
    t_bytes = case.nbytes / (spec.hbm_gbps * 1e9) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_cases(dtype, full: bool):
    """Cases at the slices' full-width shapes (``full``) or small ones."""
    from laser_tpu_torch.ops import loss
    from laser_tpu_torch.ops.attention import (attention, attention_gqa,
                                               attention_gqa_reference, attention_reference,
                                               flash_forward)
    from laser_tpu_torch.ops.attention_bwd import flash_attention_bwd_reference
    from laser_tpu_torch.ops.gemm import linear, linear_reference
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused
    from laser_tpu_torch.ops.paged_attention import quantize_kv

    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    isz = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * std).to(dtype)

    if full:  # serving prefill / decode widths and the training shapes
        M, K, N = 4096, 2048, 8192
        rows, cols = 4096, 2048
        BH, S, D = 8 * 16, 512, 128
        BHt, St = 8 * 16, 1024
        slots, H, hd, ps, pages = 8, 16, 128, 64, 16
        T, V, eps = 8 * 1023, 8192, 0.0
        # the llama path: int4 decode GEMM (w_gate), GQA prefill, int8 pages
        Mq, Kq, Nq, group = 8, 4096, 14336, 64
        Bg, Hq, Hkv = 8, 32, 8
    else:
        M, K, N = 256, 512, 2048
        rows, cols = 256, 512
        BH, S, D = 8, 200, 128
        BHt, St = 8, 200
        slots, H, hd, ps, pages = 4, 4, 128, 64, 4
        T, V, eps = 300, 8192, 0.1
        Mq, Kq, Nq, group = 17, 256, 200, 64
        Bg, Hq, Hkv = 2, 8, 2
    cases = []
    # the route each kernel takes by itself: 16-bit inputs the Hopper ones
    f32 = dtype == torch.float32
    gemm_name = "gemm_simt" if f32 else "gemm_wgmma"
    flash_name = "flash_attention" if f32 else "flash_attention_mma"
    bwd_route = "" if f32 else "_mma"

    x, w, bias = rnd(M, K), rnd(K, N, std=K ** -0.5), rnd(N, std=0.1)
    gemm_case = dict(flops=2 * M * K * N, nbytes=(M * K + K * N + M * N + N) * isz,
                     library=lambda: F.gelu(torch.addmm(bias, x, w), approximate="tanh"),
                     library_call="torch.addmm + F.gelu (two calls)")
    cases.append(Case(
        gemm_name, f"M{M} K{K} N{N} bias+gelu", lambda: linear(x, w, bias, "gelu"),
        lambda: linear_reference(x, w, bias, "gelu"), **gemm_case))
    if full:  # the WMMA kernel the wgmma route replaces, at the same shape
        cases.append(Case(
            "gemm", f"M{M} K{K} N{N} bias+gelu, the WMMA kernel asked for",
            lambda: gemm_fused(x, w, bias=bias, epilogue="gelu", route="classic"),
            lambda: linear_reference(x, w, bias, "gelu"), **gemm_case))

    cases += norm_cases(rnd, rows, cols, full)

    def causal_pairs(bh, s):
        return bh * s * (s + 1) // 2

    q, k, v = rnd(BH, S, D), rnd(BH, S, D), rnd(BH, S, D)
    flash_case = dict(
        flops=4 * D * causal_pairs(BH, S), nbytes=4 * BH * S * D * isz,
        library=lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                       is_causal=True),
        library_call="F.scaled_dot_product_attention(is_causal=True)")
    cases.append(Case(
        flash_name, f"BH{BH} S{S} D{D} causal",
        lambda: attention(q, k, v, causal=True),
        lambda: attention_reference(q, k, v, causal=True), **flash_case))
    sc = D ** -0.5
    if full:  # the FFMA kernel the tensor-core route replaces
        cases.append(Case(
            "flash_attention", f"BH{BH} S{S} D{D} causal, the FFMA kernel asked for",
            lambda: flash_forward(q, k, v, True, sc, route="ffma"),
            lambda: attention_reference(q, k, v, causal=True), **flash_case))

    # the training shapes: the stats forward and both backward kernels
    qt, kt, vt, dot = (rnd(BHt, St, D) for _ in range(4))
    train_case = dict(
        flops=4 * D * causal_pairs(BHt, St),
        nbytes=4 * BHt * St * D * isz + 2 * BHt * St * 4,
        library=_sdpa_train_forward(qt, kt, vt),
        library_call="F.scaled_dot_product_attention(is_causal=True) on inputs that "
                     "require grad (saves its logsumexp)", slot="training")
    cases.append(Case(
        flash_name, f"BH{BHt} S{St} D{D} causal, with (m, l)",
        lambda: flash_forward(qt, kt, vt, True, sc, stats=True),
        lambda: flash_forward(qt, kt, vt, True, sc, stats=True, plain=True), **train_case))
    if full:
        cases.append(Case(
            "flash_attention", f"BH{BHt} S{St} D{D} causal, with (m, l), the FFMA kernel "
            "asked for", lambda: flash_forward(qt, kt, vt, True, sc, stats=True, route="ffma"),
            lambda: flash_forward(qt, kt, vt, True, sc, stats=True, plain=True), **train_case))
    ot, mt, lt = flash_forward(qt, kt, vt, True, sc, stats=True)
    dvec = (dot.float() * ot.float()).sum(-1)
    plain_bwd = lambda: flash_attention_bwd_reference(qt, kt, vt, ot, mt, lt, dot,  # noqa: E731
                                                      causal=True, scale=sc)
    lib_bwd = _sdpa_backward(qt, kt, vt, dot)
    cases += bwd_cases(qt, kt, vt, dot, mt, lt, dvec, sc, plain_bwd, lib_bwd, bwd_route)
    if full:  # the FFMA kernels the tensor-core route replaces, in the same run
        cases += bwd_cases(qt, kt, vt, dot, mt, lt, dvec, sc, plain_bwd, lib_bwd, "",
                           route="ffma")
    if not f32:  # a ragged S at D 64 on the tensor cores
        rag = [rnd(16, 1030, 64) for _ in range(4)]  # q, k, v, dO
        rsc = 64 ** -0.5
        ro, rm, rl = flash_forward(*rag[:3], True, rsc, stats=True)
        cases += bwd_cases(
            *rag, rm, rl, (rag[3].float() * ro.float()).sum(-1), rsc,
            lambda: flash_attention_bwd_reference(*rag[:3], ro, rm, rl, rag[3], causal=True,
                                                  scale=rsc),
            _sdpa_backward(*rag), bwd_route, slot="ragged")

    P = slots * pages + 1
    qd, kp, vp = rnd(slots, H, hd), rnd(P, H, ps, hd), rnd(P, H, ps, hd)
    perm = torch.randperm(P - 1, generator=g, device=DEVICE)
    tables = perm[:slots * pages].reshape(slots, pages).int().contiguous()
    lengths = torch.linspace(0, pages * ps, slots, device=DEVICE).int()
    cases += paged_cases(qd, kp, vp, tables, lengths, full=full)

    # GQA prefill: 8 prompts x 32 query heads over 8 kv heads
    qg, kg, vg = rnd(Bg, Hq, S, D), rnd(Bg, Hkv, S, D), rnd(Bg, Hkv, S, D)
    gqa_case = dict(
        flops=4 * D * causal_pairs(Bg * Hq, S), nbytes=2 * Bg * (Hq + Hkv) * S * D * isz,
        library=_sdpa_gqa(qg, kg, vg),
        library_call="F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
        slot="gqa")
    cases.append(Case(
        flash_name, f"B{Bg} Hq{Hq} Hkv{Hkv} S{S} D{D} causal, GQA",
        lambda: attention_gqa(qg, kg, vg, causal=True),
        lambda: attention_gqa_reference(qg, kg, vg, causal=True), **gqa_case))
    if full:
        qg3, kg3, vg3 = (t.reshape(-1, S, D) for t in (qg, kg, vg))
        cases.append(Case(
            "flash_attention", f"B{Bg} Hq{Hq} Hkv{Hkv} S{S} D{D} causal, GQA, the FFMA kernel "
            "asked for", lambda: flash_forward(qg3, kg3, vg3, True, sc, kv_heads=(Hq, Hkv),
                                               route="ffma").reshape(qg.shape),
            lambda: attention_gqa_reference(qg, kg, vg, causal=True), **gqa_case))

    # int8 pages at the llama widths: q in the model dtype, K/V rows int8
    qi = rnd(slots, Hq, hd)
    kpi, ksi = quantize_kv(rnd(P, Hkv, ps, hd))
    vpi, vsi = quantize_kv(rnd(P, Hkv, ps, hd))
    cases += paged_cases(qi, kpi, vpi, tables, lengths, ksi, vsi, full=full, slot="int8")

    # the verify: W window queries per slot over the same pages, at the
    # transformer width, then over the int8 pages at the llama widths; the
    # longest window ends two positions past its table, as a full slot's
    # last verify windows do in the engine
    Wv = SPEC_GAMMA + 1
    lengths_w = torch.linspace(Wv, pages * ps + 2, slots, device=DEVICE).int()
    qw, qwi = rnd(slots, Wv, H, hd), rnd(slots, Wv, Hq, hd)
    cases += window_cases(qw, kp, vp, tables, lengths_w, full=full)
    cases += window_cases(qwi, kpi, vpi, tables, lengths_w, ksi, vsi, full=full, slot="int8")

    if f32 or not full:
        cases.append(w4_case(g, dtype, Mq, Kq, Nq, group))

    xl = rnd(T, V, std=2.0)
    tl = torch.randint(0, V, (T,), generator=g, device=DEVICE)
    cases.append(Case(
        "ce_fwd", f"T{T} V{V} eps{eps}", lambda: loss.ce_fwd(xl, tl, eps),
        lambda: loss.ce_fwd_plain(xl, tl, eps), flops=4 * T * V,
        nbytes=T * V * isz + T * 4 + 2 * T * 4,
        library=lambda: F.cross_entropy(xl, tl, reduction="none", label_smoothing=eps),
        library_call="F.cross_entropy(reduction='none')"))
    xg = xl.detach().requires_grad_(True)
    cases.append(Case(
        "ce_fused_grad", f"T{T} V{V} eps{eps}", lambda: loss.ce_fused_grad(xl, tl, eps),
        lambda: loss.ce_fused_grad_plain(xl, tl, eps), flops=6 * T * V,
        nbytes=2 * T * V * isz + T * 4 + T * 4,
        library=lambda: torch.autograd.grad(
            F.cross_entropy(xg, tl, reduction="sum", label_smoothing=eps), xg),
        library_call="F.cross_entropy forward + backward"))
    return cases + ce_bwd_cases(g, full)


def ce_bwd_cases(g, full: bool):
    """Row 9 at T 2048 x V 256000 (gemma-7b's vocabulary) in bf16 and f32
    with eps 0 and 0.1, and on phase 17's f32 chunk logits: T 4092 at column
    3 x 8192 of the Llama-3 vocabulary and its ragged last chunk (``full``);
    one f32 case at a column offset otherwise."""
    from laser_tpu_torch.ops import loss

    def case(T, W, c0, V, dtype, eps, slot, library=True):
        x = (torch.randn((T, W), generator=g, device=DEVICE) * 2).to(dtype)
        t = torch.randint(0, V, (T,), generator=g, device=DEVICE)
        t[::2] = torch.randint(c0, c0 + W, (len(t[::2]),), generator=g, device=DEVICE)
        # the full row's lse is at least the tile's: p stays below 1
        lse = torch.logsumexp(x.float(), dim=-1) + (0.0 if W == V else 1.0)
        gr = torch.rand(T, generator=g, device=DEVICE) / T
        lib, call = None, None
        if library:  # the backward alone: the forward is taken outside the timer
            xg = x.detach().requires_grad_(True)
            out = F.cross_entropy(xg, t, reduction="none", label_smoothing=eps)
            lib = lambda: torch.autograd.grad(out, xg, gr, retain_graph=True)  # noqa: E731
            call = "torch.autograd.grad of F.cross_entropy(reduction='none') (backward alone)"
        isz = x.element_size()
        return Case("ce_bwd", f"T{T} V{V} columns [{c0}, {c0 + W}) eps{eps}",
                    lambda: loss.ce_bwd(x, t, lse, gr, eps, c0=c0, V=V),
                    lambda: loss.ce_bwd_plain(x, t, lse, gr, eps, c0=c0, V=V),
                    flops=6 * T * W, nbytes=2 * T * W * isz + 3 * T * 4, library=lib,
                    library_call=call, slot=slot, dtype=dtype, rel=CE_BWD_REL[dtype])

    if not full:
        return [case(300, 1000, 5000, 8192, torch.float32, 0.1, "", library=False)]
    bf, f32 = torch.bfloat16, torch.float32
    Vl, bv = LLAMA["vocab"], 8192
    Tl = LLAMA_TRAIN_BATCH[0] * (LLAMA_TRAIN_BATCH[1] - 1)
    return [case(2048, 256000, 0, 256000, bf, 0.0, ""),
            case(2048, 256000, 0, 256000, bf, 0.1, "eps0.1"),
            case(2048, 256000, 0, 256000, f32, 0.0, "f32"),
            case(2048, 256000, 0, 256000, f32, 0.1, "f32_eps0.1"),
            case(Tl, bv, 3 * bv, Vl, f32, 0.0, "llama_chunk", library=False),
            case(Tl, Vl - Vl // bv * bv, Vl // bv * bv, Vl, f32, 0.0, "llama_last_chunk",
                 library=False)]


def w4_case(g, dtype, M, K, N, group, slot="", name="w4_gemm", route=None, note="",
            cold=False):
    """The int4 weight GEMM on a (K, N) weight quantized from N(0, 1/K), on
    the route the library picks or ``route``; ``name`` the counter that
    must move. ``cold``: also over copies of the weight that exceed L2."""
    from laser_tpu_torch.ops.gemm.int4_kernel import dequantize_int4, gemm_w4, gemm_w4_plain
    from laser_tpu_torch.ops.gemm.int4_kernel import quantize_int4

    isz = torch.tensor([], dtype=dtype).element_size()
    h = torch.randn((M, K), generator=g, device=DEVICE).to(dtype)
    packed = K * N // 2 + (K // group) * N * 4

    def weight():
        return quantize_int4(torch.randn((K, N), generator=g, device=DEVICE) * K ** -0.5,
                             group=group)
    copies = cold_copies(weight, packed) if cold else [weight()]
    wq = copies[0]
    wd = dequantize_int4(wq).to(dtype)
    cold_runs = None
    if cold:  # the library call's copies are the dequantized weights, 4x the bytes
        cold_runs = (rotating(lambda c: gemm_w4(h, c, route=route), [(c,) for c in copies]),
                     rotating(lambda c: torch.matmul(h, c),
                              [(dequantize_int4(c).to(dtype),) for c in copies]))
    return Case(name, f"M{M} K{K} N{N} group{group}{note}", lambda: gemm_w4(h, wq, route=route),
                lambda: gemm_w4_plain(h, wq), flops=2 * M * K * N,
                nbytes=M * K * isz + K * N // 2 + (K // group) * N * 4 + M * N * isz,
                library=lambda: torch.matmul(h, wd),
                library_call="torch.matmul on the dequantized weight in the activation "
                             "dtype: the same product from 4x the weight bytes (bf16)",
                slot=slot, cold=cold_runs)


def cold_copies(make, nbytes):
    """``make()`` and further calls of it, enough that the ``nbytes`` each
    call moves, over all copies, exceed the L2 cache: inputs a rotating
    timing finds cold, as a serving step finds its activations and pages."""
    return [make() for _ in range(max(2, math.ceil(COLD_BYTES / nbytes)))]


def norm_cases(rnd, rows, cols, full: bool):
    """Row 2: the layer norm at the serving prefill's rows (gains in the
    rows' dtype, as every model keeps them) on the route the library picks
    (``norm_vec`` where the row is whole 16-byte vectors) and, at full size,
    on the classic kernel asked for; the RMS norm at the Llama width, prefill
    (4096 rows) and decode (8 rows), the same two ways. Each also as 20
    calls in a CUDA graph, and at full size the prefill rows over copies of
    x past L2."""
    from laser_tpu_torch.ops.norm import (layer_norm, layer_norm_reference, rms_norm,
                                          rms_norm_reference)

    gam, bet = rnd(cols), rnd(cols, std=0.1)
    isz = gam.element_size()
    nbytes = (2 * rows * cols + 2 * cols) * isz
    xs = cold_copies(lambda: rnd(rows, cols), nbytes) if full else [rnd(rows, cols)]
    xn = xs[0]
    cases = []
    classic = ", the classic kernel asked for"

    def layer(x, route=None):
        return layer_norm(x, gam, bet, route=route)

    def lib(x=xn):
        return F.layer_norm(x, (cols,), gam, bet, eps=1e-6)

    for route in (None, "classic") if full else (None,):
        cases.append(Case(
            "norm" if route else "norm_vec", f"{rows}x{cols} layer{classic if route else ''}",
            lambda route=route: layer(xn, route), lambda: layer_norm_reference(xn, gam, bet),
            flops=8 * rows * cols, nbytes=nbytes, library=lib, library_call="F.layer_norm",
            graph=True, cold=(rotating(lambda x, route=route: layer(x, route),
                                       [(x,) for x in xs]),
                              rotating(lib, [(x,) for x in xs])) if full else None))
    if not full:
        return cases
    width = LLAMA["d_model"]
    gr = rnd(width)
    for r in (rows, 8):
        nbytes = (2 * r * width + width) * isz
        xrs = cold_copies(lambda r=r: rnd(r, width), nbytes) if r == rows else [rnd(r, width)]
        xr = xrs[0]
        lib = None
        if hasattr(F, "rms_norm"):
            lib = lambda x=xr: F.rms_norm(x, (width,), gr, eps=1e-6)  # noqa: E731
        for route in (None, "classic"):
            cold = None
            if len(xrs) > 1 and lib:
                cold = (rotating(lambda x, route=route: rms_norm(x, gr, route=route),
                                 [(x,) for x in xrs]), rotating(lib, [(x,) for x in xrs]))
            cases.append(Case(
                "norm" if route else "norm_vec",
                f"{r}x{width} rms{classic if route else ''}",
                lambda xr=xr, route=route: rms_norm(xr, gr, route=route),
                lambda xr=xr: rms_norm_reference(xr, gr), flops=5 * r * width,
                nbytes=nbytes, library=lib, library_call="F.rms_norm" if lib else None,
                slot=f"rms_{r}x{width}", graph=True, cold=cold))
    return cases


def same_bits(what, *runs):
    """Fail unless every one of ``runs`` gives the first one's bits."""
    outs = [run() for run in runs]
    same = [torch.equal(outs[0], o) for o in outs[1:]]
    print(f"  {what}: the same bits {same}", flush=True)
    if not all(same):
        fail(f"{what}: the bits differ {same}")


def paged_pools(kp, vp, ks, vs, nbytes, cold):
    """The pools (and int8 scales) as given and, with ``cold``, copies of
    them, enough that the ``nbytes`` a call moves exceed L2 over all."""
    pools = [(kp, vp, ks, vs)]
    if cold:
        pools += cold_copies(lambda: tuple(None if t is None else t.clone()
                                           for t in (kp, vp, ks, vs)), nbytes)[1:]
    return pools


def paged_cases(q, kp, vp, tables, lengths, ks=None, vs=None, full=False, slot=""):
    """Row 4: the decode kernel over the pages on the route the library picks
    (16-bit q: ``paged_attention_split``) and, at full size, on the classic
    kernel asked for, each also over copies of the pools past L2; bytes
    count every key of each slot once. The library call is the verify's
    comparator at W = 1: SDPA with the key mask on K/V gathered beforehand
    (dequantized for int8 pages), the gather not timed. On the split route
    the decode gives the same bits twice, and the verify's at W = 1."""
    from laser_tpu_torch.ops.paged_attention import (paged_attention, paged_attention_reference,
                                                     paged_window_attention)

    S, Hq, hd = q.shape
    Hkv, ps = kp.shape[1], kp.shape[2]
    isz = q.element_size()
    keys = int(lengths.clamp(max=tables.shape[1] * ps).sum().item())
    row = hd * isz if ks is None else hd + 4
    nbytes = 2 * keys * Hkv * row + 2 * S * Hq * hd * isz + tables.numel() * 4 + S * 4
    f32 = q.dtype == torch.float32
    pools = paged_pools(kp, vp, ks, vs, nbytes, full)
    libs = [_sdpa_window(q[:, None], *p[:2], tables, lengths, *p[2:]) for p in pools]

    def run(k, v, k_s, v_s, route=None, window=False):
        kw = {} if k_s is None else dict(k_scale=k_s, v_scale=v_s)
        if window:
            return paged_window_attention(q[:, None], k, v, tables, lengths, route=route,
                                          **kw)[:, 0]
        return paged_attention(q, k, v, tables, lengths, route=route, **kw)

    if not f32:
        same_bits(f"paged split route, decode twice and verify at W 1, {slot or 'bf16'} pages",
                  lambda: run(*pools[0], "split"), lambda: run(*pools[0], "split"),
                  lambda: run(*pools[0], "split", window=True))
    cases = []
    for route in (None, "classic") if full else (None,):
        name = "paged_attention" if route or f32 else "paged_attention_split"
        cases.append(Case(
            name, f"slots{S} Hq{Hq} Hkv{Hkv} hd{hd} ps{ps} pages{tables.shape[1]} lengths "
            f"0..{int(lengths.max().item())}{', int8 pages' if ks is not None else ''}"
            f"{', the classic kernel asked for' if route else ''}",
            lambda route=route: run(*pools[0], route),
            lambda: paged_attention_reference(q, kp, vp, tables, lengths,
                                              **({} if ks is None else dict(k_scale=ks,
                                                                            v_scale=vs))),
            flops=4 * keys * Hq * hd, nbytes=nbytes, library=libs[0],
            library_call="F.scaled_dot_product_attention with the key mask on K/V already "
                         "gathered from the pages (dequantized for int8 pages); the gather is "
                         "not timed", slot=slot, per_row=True, graph=full,
            cold=(rotating(lambda *p, route=route: run(*p, route), pools),
                  rotating(lambda f: f(), [(f,) for f in libs])) if full else None))
    return cases


def window_cases(q, kp, vp, tables, lengths, ks=None, vs=None, full=False, slot=""):
    """Row 5: the paged window kernel on the route the library picks (16-bit
    q: ``paged_window_attention_split``) and, at full size, on the classic
    kernel asked for, each also over copies of the pools past L2; bytes
    count every key of each slot once (its last query reads them all),
    operations every causal pair. Held to its bound row by row: a row over
    5 keys is a few times the size of one over a thousand, so a bound on
    the whole output would let the long slots drift. On the split route two
    calls give the same bits."""
    from laser_tpu_torch.ops.paged_attention import (paged_window_attention,
                                                     paged_window_attention_reference)

    S, W, Hq, hd = q.shape
    Hkv, ps = kp.shape[1], kp.shape[2]
    cap = tables.shape[1] * ps  # keys a table row holds
    isz = q.element_size()
    lens = lengths.tolist()
    keys = sum(min(n, cap) for n in lens)
    pairs = sum(min(max(n - W + w + 1, 0), cap) for n in lens if n > 0 for w in range(W))
    row = hd * isz if ks is None else hd + 4
    nbytes = 2 * keys * Hkv * row + 2 * S * W * Hq * hd * isz + tables.numel() * 4 + S * 4
    f32 = q.dtype == torch.float32
    pools = paged_pools(kp, vp, ks, vs, nbytes, full and not f32)
    libs = [_sdpa_window(q, *p[:2], tables, lengths, *p[2:]) for p in pools]

    def run(k, v, k_s, v_s, route=None):
        kw = {} if k_s is None else dict(k_scale=k_s, v_scale=v_s)
        return paged_window_attention(q, k, v, tables, lengths, route=route, **kw)

    if not f32:
        same_bits(f"paged split route, verify twice, {slot or 'bf16'} pages",
                  lambda: run(*pools[0], "split"), lambda: run(*pools[0], "split"))
    cases = []
    for route in (None, "classic") if full else (None,):
        cases.append(Case(
            "paged_window_attention" if route or f32 else "paged_window_attention_split",
            f"slots{S} W{W} Hq{Hq} Hkv{Hkv} hd{hd} ps{ps} pages{tables.shape[1]} lengths "
            f"{min(lens)}..{max(lens)}{', int8 pages' if ks is not None else ''}"
            f"{', the classic kernel asked for' if route else ''}",
            lambda route=route: run(*pools[0], route),
            lambda: paged_window_attention_reference(
                q, kp, vp, tables, lengths, **({} if ks is None else dict(k_scale=ks,
                                                                          v_scale=vs))),
            flops=4 * hd * Hq * pairs, nbytes=nbytes, library=libs[0],
            library_call="F.scaled_dot_product_attention with the causal window mask on K/V "
                         "already gathered from the pages (dequantized for int8 pages); the "
                         "gather is not timed", slot=slot, per_row=True, graph=not f32,
            cold=(rotating(lambda *p, route=route: run(*p, route), pools),
                  rotating(lambda f: f(), [(f,) for f in libs])) if len(pools) > 1 else None))
    return cases


def _sdpa_window(q, kp, vp, tables, lengths, ks, vs):
    S, W, Hq, hd = q.shape
    Hkv = kp.shape[1]
    if ks is not None:
        kp = (kp.float() * ks[..., None]).to(q.dtype)
        vp = (vp.float() * vs[..., None]).to(q.dtype)
    t = tables.long()
    k = kp[t].transpose(1, 2).reshape(S, Hkv, -1, hd)
    v = vp[t].transpose(1, 2).reshape(S, Hkv, -1, hd)
    qpos = lengths.long()[:, None] - W + torch.arange(W, device=q.device)
    mask = (torch.arange(k.shape[2], device=q.device)[None, None, :] <= qpos[:, :, None])[:, None]
    qh = q.transpose(1, 2).contiguous()  # (S, Hq, W, hd)
    kw = {}
    if Hq != Hkv:
        if _sdpa_gqa(qh, k, v) is None:
            return None
        kw = dict(enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, **kw)


def _sdpa_gqa(q, k, v):
    """SDPA with enable_gqa where the installed PyTorch has it, else None."""
    try:
        F.scaled_dot_product_attention(q[:1, :, :2], k[:1, :, :2], v[:1, :, :2],
                                       is_causal=True, enable_gqa=True)
    except TypeError:
        return None
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)


def _sdpa_train_forward(q, k, v):
    qg, kg, vg = (t[None].detach().requires_grad_(True) for t in (q, k, v))

    def run():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    return run


def bwd_cases(q, k, v, do, m, l, dvec, sc, plain_bwd, lib_bwd, suffix, route=None, slot=""):
    """Rows 6 and 7 (the flash backward's dq and dk/dv kernels) at q's
    (BH, S, D), causal, on the route the library picks (``suffix`` the
    record's: "_mma" for 16-bit inputs) or on ``route`` asked for; the
    library call is SDPA's whole backward (dq, dk, dv in one call) for
    both."""
    from laser_tpu_torch.ops.attention_bwd import bwd_dkv_cuda, bwd_dq_cuda

    BH, S, D = q.shape
    pairs, isz, stats_bytes = BH * S * (S + 1) // 2, q.element_size(), 3 * BH * S * 4
    note = ", the FFMA kernel asked for" if route == "ffma" else ""
    call = ("autograd of F.scaled_dot_product_attention(is_causal=True): dq, dk, dv in one "
            "backward")
    return [
        Case(f"flash_attention_bwd_dq{suffix}", f"BH{BH} S{S} D{D} causal{note}",
             lambda: bwd_dq_cuda(q, k, v, do, m, l, dvec, True, sc, route),
             lambda: plain_bwd()[0], flops=3 * 2 * D * pairs,
             nbytes=5 * BH * S * D * isz + stats_bytes, library=lib_bwd, library_call=call,
             slot=slot),
        Case(f"flash_attention_bwd_dkv{suffix}", f"BH{BH} S{S} D{D} causal{note}",
             lambda: bwd_dkv_cuda(q, k, v, do, m, l, dvec, True, sc, route),
             lambda: plain_bwd()[1:], flops=4 * 2 * D * pairs,
             nbytes=6 * BH * S * D * isz + stats_bytes, library=lib_bwd, library_call=call,
             slot=slot)]


def _sdpa_backward(q, k, v, do):
    qg, kg, vg = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do[None], retain_graph=True)


def decode_cases():
    """The weight-streaming products (bf16 unless stated), each on the
    route the library picks and, at its main shape, on the kernel that route
    replaces (asked for by ``route="classic"``): the decode product (8 rows
    against the wqkv weight) and the speculative verify's 40 rows; the
    Llama-3-8B decode products (w_gate / w_up and w_down) bf16 and int4;
    the int4 prefill; C1's head in f32."""
    from laser_tpu_torch.ops.gemm import linear, linear_reference
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused

    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)

    def dense(M, K, N, slot, dtype=torch.bfloat16, name="gemm_splitk", route=None, note=""):
        x = torch.randn((M, K), generator=g, device=DEVICE).to(dtype)
        ws = cold_copies(lambda: (torch.randn((K, N), generator=g, device=DEVICE)
                                  * K ** -0.5).to(dtype), K * N * x.element_size())
        w = ws[0]
        b = (torch.randn((N,), generator=g, device=DEVICE) * 0.1).to(dtype)

        def run(w=w):
            return linear(x, w, b) if route is None else gemm_fused(x, w, bias=b, route=route)
        return Case(name, f"M{M} K{K} N{N} bias{note}", run, lambda: linear_reference(x, w, b),
                    flops=2 * M * K * N, nbytes=(M * K + K * N + M * N + N) * x.element_size(),
                    library=lambda: torch.addmm(b, x, w), library_call="torch.addmm", slot=slot,
                    dtype=dtype, cold=(rotating(run, [(c,) for c in ws]),
                                       rotating(lambda c: torch.addmm(b, x, c), [(c,) for c in ws])))

    classic = ", the WMMA kernel asked for"
    cases = [
        dense(8, 2048, 6144, ""),
        dense(8, 2048, 6144, "decode", name="gemm", route="classic", note=classic),
        dense(40, 2048, 6144, "verify_m40"),
        dense(8, 4096, 14336, "llama_w_gate"),
        dense(8, 14336, 4096, "llama_w_down"),
        dense(16, 50176, 128, "c1_head", dtype=torch.float32),
        dense(16, 50176, 128, "c1_head", dtype=torch.float32, name="gemm", route="classic",
              note=", the FFMA kernel asked for"),
        w4_case(g, torch.bfloat16, 8, 4096, 14336, 64, name="w4_gemm_stream", cold=True),
        w4_case(g, torch.bfloat16, 8, 14336, 4096, 64, slot="llama_w_down",
                name="w4_gemm_stream", cold=True),
        w4_case(g, torch.bfloat16, 8, 4096, 14336, 64, route="classic", note=classic, cold=True),
        w4_case(g, torch.bfloat16, 4096, 4096, 14336, 64, name="w4_gemm_mma"),
        w4_case(g, torch.bfloat16, 4096, 4096, 14336, 64, slot="prefill", route="classic",
                note=classic),
    ]
    for c in cases:
        c.graph = True
    return cases


def cnn_cases():
    """The CNN path's kernels at C1's shapes in f32 (conv 1 planewise, convs
    2 and 3 on the direct conv's ffma route, the (16, 1000) softmax), conv 3
    in bf16 (the mma route), conv 3's input at stride 2 (one launch), each
    direct case again on the classic kernels asked for (at stride 2, the
    phase convs), and the softmax kernels at bench.py:421's 8192 x 4096 and
    at 64 rows of Llama-3's 128256-word vocabulary (online)."""
    from laser_tpu_torch.ops.conv import (conv2d_direct, conv2d_direct_reference,
                                          conv2d_planewise_reference, conv2d_required_ops,
                                          conv_planewise)
    from laser_tpu_torch.ops.vector_math import (SOFTMAX_ROW_MAX_COLS, softmax,
                                                 softmax_online_reference, softmax_reference)

    g = torch.Generator(device=DEVICE)
    g.manual_seed(5)

    def conv_case(name, xs, ws, kern, plain, dtype=torch.float32, stride=1, slot=""):
        x = torch.randn(xs, generator=g, device=DEVICE).to(dtype)
        w = (torch.randn(ws, generator=g, device=DEVICE) * (ws[1] * 9) ** -0.5).to(dtype)
        N, _, H, W = xs
        oh, ow = (H - 1) // stride + 1, (W - 1) // stride + 1
        isz = x.element_size()
        return Case(
            name, f"N{N} C{xs[1]}->{ws[0]} {H}x{W} k3 p1" + (f" s{stride}" if stride > 1 else ""),
            lambda: kern(x, w), lambda: plain(x, w),
            flops=conv2d_required_ops(xs, ws, (1, 1), (stride, stride)),
            nbytes=(x.numel() + w.numel() + N * ws[0] * oh * ow) * isz,
            library=lambda: F.conv2d(x, w, padding=1, stride=stride),
            library_call="F.conv2d (cuDNN, TF32 off)", slot=slot, dtype=dtype)

    inputs = {}

    def softmax_case(name, rows, cols, plain, slot="", dtype=torch.float32, route=None):
        # the same rows for every route at one shape and dtype
        key = (rows, cols, dtype)
        if key not in inputs:
            inputs[key] = (torch.randn((rows, cols), generator=g, device=DEVICE) * 4).to(dtype)
        x = inputs[key]
        lib = inputs.setdefault(key + ("library",), lambda: torch.softmax(x, -1))
        small = rows * cols <= 16 * 1000
        nbytes = 2 * rows * cols * x.element_size()
        online = cols > SOFTMAX_ROW_MAX_COLS
        cold = None
        if online:  # the graph over copies of the rows past L2, kernel and library
            if key + ("copies",) not in inputs:
                copies = cold_copies(lambda: (torch.randn((rows, cols), generator=g,
                                                          device=DEVICE) * 4).to(dtype), nbytes)
                inputs[key + ("copies",)] = [(c,) for c in copies]
                inputs[key + ("cold library",)] = rotating(lambda c: torch.softmax(c, -1),
                                                           inputs[key + ("copies",)])
            cold = (rotating(lambda c, route=route: softmax(c, route=route),
                             inputs[key + ("copies",)]), inputs[key + ("cold library",)])
        return Case(name, f"{rows}x{cols} {DTYPE_TAGS[dtype]}"
                    + (", the classic kernel asked for" if route else ""),
                    lambda: softmax(x, route=route), lambda: plain(x),
                    flops=5 * rows * cols, nbytes=nbytes,
                    library=lib, library_call="torch.softmax", slot=slot, per_row=True,
                    dtype=torch.float32, rel=REL_BOUND[torch.float32 if dtype == torch.float32
                                                      else torch.bfloat16],
                    graph=small or online, host=small or online, cold=cold,
                    tol=ONLINE_TOL[dtype] if online else None)

    p1, s2 = (1, 1), (2, 2)

    def direct(route=None, strides=(1, 1)):
        return lambda x, w: conv2d_direct(x, w, p1, strides, route=route)

    def plain(strides=(1, 1)):
        return lambda x, w: conv2d_direct_reference(x, w, p1, strides)

    c2 = ((16, 20, 112, 112), (64, 20, 3, 3))
    c3 = ((16, 64, 56, 56), (64, 64, 3, 3))
    bf16 = torch.bfloat16
    return [
        conv_case("conv_planewise", (16, 3, 224, 224), (20, 3, 3, 3),
                  lambda x, w: conv_planewise(x, w, p1),
                  lambda x, w: conv2d_planewise_reference(x, w, p1)),
        # the routes the library picks
        conv_case("conv_direct_ffma", *c2, direct(), plain()),
        conv_case("conv_direct_ffma", *c3, direct(), plain(), slot="conv3"),
        conv_case("conv_direct_ffma", *c3, direct(strides=s2), plain(s2), stride=2,
                  slot="strided"),
        conv_case("conv_direct_mma", *c3, direct(), plain(), dtype=bf16),
        conv_case("conv_direct_mma", *c3, direct(strides=s2), plain(s2), dtype=bf16, stride=2,
                  slot="strided"),
        # the classic kernels asked for, in the same run (at stride 2:
        # laser_tpu's phase convs on them, the 1x1 phase through torch.matmul)
        conv_case("conv_direct", *c2, direct("classic"), plain()),
        conv_case("conv_direct", *c3, direct("classic"), plain(), slot="conv3"),
        conv_case("conv_direct", *c3, direct("classic"), plain(), dtype=bf16,
                  slot="conv3_bf16"),
        conv_case("conv_direct", *c3, direct("classic", s2), plain(s2), stride=2,
                  slot="strided"),
        # C1's and the MLP's head, bench.py:421's rows, each in f32 and bf16
        # on the vec kernel, then on the classic kernel asked for
        softmax_case("softmax_vec", 16, 1000, softmax_reference),
        softmax_case("softmax_vec", 8192, 4096, softmax_reference, slot="bench"),
        softmax_case("softmax_vec", 16, 1000, softmax_reference, slot="bf16", dtype=bf16),
        softmax_case("softmax_vec", 8192, 4096, softmax_reference, slot="bench_bf16",
                     dtype=bf16),
        softmax_case("softmax", 16, 1000, softmax_reference, route="classic"),
        softmax_case("softmax", 8192, 4096, softmax_reference, slot="bench", route="classic"),
        softmax_case("softmax", 16, 1000, softmax_reference, slot="bf16", dtype=bf16,
                     route="classic"),
        softmax_case("softmax", 8192, 4096, softmax_reference, slot="bench_bf16", dtype=bf16,
                     route="classic"),
        # 64 rows of Llama-3's 128256-word vocabulary in f32 and bf16 (online):
        # the cluster kernel, then the classic online kernel asked for
        softmax_case("softmax_online_cluster", 64, 128256, softmax_online_reference),
        softmax_case("softmax_online_cluster", 64, 128256, softmax_online_reference,
                     slot="bf16", dtype=bf16),
        softmax_case("softmax_online", 64, 128256, softmax_online_reference, route="classic"),
        softmax_case("softmax_online", 64, 128256, softmax_online_reference, slot="bf16",
                     dtype=bf16, route="classic"),
    ]


# the rows at which the GEMM routes are timed against each other: the
# crossovers behind csrc/gemm.cu's SPLITK_MAX_M and WG_MIN_M (and its int8
# routes) and csrc/w4_gemm.cu's W4_STREAM_MAX_M
CROSSOVER_M = (1, 8, 16, 32, 40, 64, 128)
CROSSOVER_F32_M = (16, 32, 64, 128, 256)


def _crossover_row(label, runs):
    """Device ms per call (20 calls in a CUDA graph) of each route in
    ``runs`` ({route: fn}), printed on one line."""
    row = {r: cuda_graph_ms(fn) for r, fn in runs.items()}
    print(f"  {label}: " + ", ".join(f"{r} {t:.4f}" for r, t in row.items()) + " ms", flush=True)
    return row


def gemm_crossover():
    """Every GEMM route asked for by ``route=`` at M rows of the decode
    product (K 2048, N 6144), of Llama-3-8B's w_down (K 14336, N 4096) and
    of the transformer's w2 (K 8192, N 2048),
    bf16 with a bias (split-K up to 64 rows); f32 split-K (up to 64 rows),
    simt and the classic FFMA kernel on the decode product at M 16 to 256;
    int8 -> int32 at K 4096, N 4096 on the wgmma route (B row-major, copied
    K-major first in the call, and B given K-major) and the WMMA kernel at M 1 to
    128; the int4 routes at M rows of the Llama
    w_gate product (K 4096, N 14336, group 64; stream up to 64 rows).
    Device ms a call, 20 in a CUDA graph: {product: {M: {route: ms}}}."""
    from laser_tpu_torch.ops.gemm.int4_kernel import gemm_w4, quantize_int4
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused

    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    out = {}
    for dtype, (K, N), ms, routes in (
            (torch.bfloat16, (2048, 6144), CROSSOVER_M, ("splitk", "wgmma", "classic")),
            (torch.bfloat16, (14336, 4096), CROSSOVER_M, ("splitk", "wgmma", "classic")),
            (torch.bfloat16, (8192, 2048), CROSSOVER_M, ("splitk", "wgmma", "classic")),
            (torch.float32, (2048, 6144), CROSSOVER_F32_M, ("splitk", "simt", "classic"))):
        key = f"{DTYPE_TAGS[dtype]} K{K} N{N}"
        w = (torch.randn((K, N), generator=g, device=DEVICE) * K ** -0.5).to(dtype)
        b = torch.zeros((N,), device=DEVICE, dtype=dtype)
        out[key] = {}
        for M in ms:
            x = torch.randn((M, K), generator=g, device=DEVICE).to(dtype)
            out[key][f"M{M}"] = _crossover_row(f"{key} M{M}", {
                r: (lambda r=r, x=x: gemm_fused(x, w, bias=b, route=r)) for r in routes
                if r != "splitk" or M <= 64})
    # int8 -> int32 (K 4096, N 4096): the wgmma route on a row-major B (its
    # K-major copy in the call) and on a K-major B (none), the WMMA kernel
    K, N = 4096, 4096
    w8 = torch.randint(-8, 8, (K, N), generator=g, device=DEVICE, dtype=torch.int8)
    w8t = w8.t().contiguous()
    key = f"int8 K{K} N{N}"
    out[key] = {}
    for M in CROSSOVER_M:
        x = torch.randint(-8, 8, (M, K), generator=g, device=DEVICE, dtype=torch.int8)
        out[key][f"M{M}"] = _crossover_row(f"{key} M{M}", {
            "wgmma": lambda x=x: gemm_fused(x, w8, route="wgmma"),
            "wgmma_bt": lambda x=x: gemm_fused(x, w8t, transpose_b=True, route="wgmma"),
            "classic": lambda x=x: gemm_fused(x, w8, route="classic")})
    K, N = 4096, 14336
    wq = quantize_int4(torch.randn((K, N), generator=g, device=DEVICE) * K ** -0.5, group=64)
    key = f"int4 K{K} N{N} group64"
    out[key] = {}
    for M in CROSSOVER_M:
        x = torch.randn((M, K), generator=g, device=DEVICE).bfloat16()
        out[key][f"M{M}"] = _crossover_row(f"{key} M{M}", {
            r: (lambda r=r, x=x: gemm_w4(x, wq, route=r)) for r in ("stream", "mma", "classic")
            if r != "stream" or M <= 64})
    return out


def f32_gemm_cases():
    """Row 1's f32 product at its main shape, Lux's relu(a @ b + bias) at
    M4096 K2048 N2048 (phase 13): on the route the library picks (simt) and
    on the classic FFMA kernel asked for, which must give the same bits;
    the library call ``torch.relu(torch.addmm(...))`` with TF32 off."""
    from laser_tpu_torch.ops.gemm.kernel import gemm_fused, gemm_plain

    g = torch.Generator(device=DEVICE)
    g.manual_seed(5)
    M, K, N = 4096, 2048, 2048
    x = torch.randn(M, K, generator=g, device=DEVICE)
    w = torch.randn(K, N, generator=g, device=DEVICE) * K ** -0.5
    bias = torch.randn(N, generator=g, device=DEVICE) * 0.1
    simt = lambda: gemm_fused(x, w, bias=bias, epilogue="relu")  # noqa: E731
    classic = lambda: gemm_fused(x, w, bias=bias, epilogue="relu", route="classic")  # noqa: E731
    same_bits(f"gemm f32 M{M} K{K} N{N} bias+relu, simt and classic routes", simt, classic)
    kw = dict(plain=lambda: gemm_plain(x, w, bias=bias, epilogue="relu"),
              flops=2 * M * K * N, nbytes=(M * K + K * N + M * N + N) * 4,
              library=lambda: torch.relu(torch.addmm(bias, x, w)),
              library_call="torch.relu(torch.addmm(bias, a, b)), TF32 off", dtype=torch.float32)
    return [Case("gemm_simt", f"M{M} K{K} N{N} bias+relu f32", simt, **kw),
            Case("gemm", f"M{M} K{K} N{N} bias+relu f32, the FFMA kernel asked for", classic,
                 slot="f32", **kw)]


def check_route(case: Case):
    """Run the case once with the counts at 0: its kernel record (the route)
    must have launched. Returns the output."""
    from laser_tpu_torch import registry

    torch.cuda.synchronize()
    registry.reset_counts()
    got = case.kern()
    torch.cuda.synchronize()
    if registry.KERNELS[case.name].launches == 0:
        fail(f"{case.name} {case.shape}: its route never launched "
             f"({ {k: v for k, v in registry.counts().items() if v['launches']} })")
    return got


def phase_kernels(spec):
    print("phase 2: kernels vs plain versions", flush=True)
    record = {}
    f32 = kernel_cases(torch.float32, full=False)
    timed = (kernel_cases(torch.bfloat16, full=True) + f32_gemm_cases() + decode_cases()
             + cnn_cases())
    for case in f32:
        compare(f"{case.name} {case.shape} [f32]", check_route(case), case.plain(),
                case.per_row, case.rel)
    table_small_checks()
    library_small_checks()
    library_times = {}  # one timing of each library call, shared by the cases that race it
    for case in timed:
        err = compare(f"{case.name} {case.shape} [{DTYPE_TAGS[case.dtype]}]", check_route(case),
                      case.plain(), case.per_row, case.rel, case.tol)
        ms, pms = cuda_ms(case.kern), cuda_ms(case.plain, reps=5)
        batched = cuda_batched_ms(case.kern)
        if case.library and id(case.library) not in library_times:
            library_times[id(case.library)] = (cuda_ms(case.library),
                                               cuda_batched_ms(case.library))
        lms, lbatched = library_times.get(id(case.library), (None, None))
        gms = cuda_graph_ms(case.kern) if case.graph else None
        lgms = cuda_graph_ms(case.library) if case.graph and case.library else None
        cgms, clgms = (cuda_graph_ms(f) for f in case.cold) if case.cold else (None, None)
        hus = host_us(case.kern) if case.host else None
        lhus = host_us(case.library) if case.host and case.library else None
        bms, by = bound(case, spec)
        lib = "none" if lms is None else f"{lms:.4f} ms ({lbatched:.4f} ms 20 in a row)"
        graph = "" if gms is None else (f"; in a CUDA graph: kernel {gms:.4f} ms, library "
                                        f"{'none' if lgms is None else f'{lgms:.4f} ms'}")
        if cgms is not None:
            graph += f"; cold L2: kernel {cgms:.4f} ms, library {clgms:.4f} ms"
        if hus is not None:
            graph += (f"; host: kernel {hus:.2f} us a call, library "
                      f"{'none' if lhus is None else f'{lhus:.2f} us'}")
        print(f"    time: kernel {ms:.4f} ms ({batched:.4f} ms per call of 20 in a row), plain "
              f"{pms:.4f} ms, library {lib}, bound {bms:.4f} ms ({by}){graph}", flush=True)
        entry = {"shape": case.shape, "max_abs_err": err, "ms": ms, "batched_ms": batched,
                 "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms,
                 "library_batched_ms": lbatched, "graph_ms": gms, "library_graph_ms": lgms,
                 "cold_graph_ms": cgms, "library_cold_graph_ms": clgms, "host_us": hus,
                 "library_host_us": lhus, "library_call": case.library_call}
        if case.slot:
            record.setdefault(case.name, {})[case.slot] = entry
        else:
            record[case.name] = {**entry, **record.get(case.name, {})}
    record["gemm_splitk"]["crossover"] = gemm_crossover()
    return record


def traffic(vocab: int):
    rs = np.random.RandomState(0)
    lens = rs.randint(100, 513, size=N_REQUESTS)
    return [rs.randint(0, vocab, size=n).astype(np.int32) for n in lens]


def serve(params, n_heads, prompts, keep_first_logits=False, model="transformer", *,
          cfg=SERVE_CFG, new_tokens=NEW_TOKENS, draft=None, draft_n_heads=None, **quant):
    """One engine over ``prompts``: (engine, tokens per request, wall s).
    ``quant``: more ServingConfig fields (quantisation, speculation)."""
    from laser_tpu_torch.serving import ServingConfig, ServingEngine

    eng = ServingEngine(params, n_heads=n_heads, model=model,
                        cfg=ServingConfig(**{**cfg, **quant}),
                        keep_first_logits=keep_first_logits, draft_params=draft,
                        draft_n_heads=draft_n_heads)
    ids = [eng.add_request(p, new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, [out[i] for i in ids], wall


def check_tokens(outs, vocab, n=NEW_TOKENS):
    for i, toks in enumerate(outs):
        if len(toks) != n or not all(0 <= t < vocab for t in toks):
            fail(f"request {i}: {len(toks)} tokens, range "
                 f"[{min(toks, default=-1)}, {max(toks, default=-1)}]")


def gemm_launches(counts):
    """Launches of the GEMM kernel over its three routes."""
    from laser_tpu_torch.ops.gemm.kernel import ROUTE_KERNELS

    return sum(counts[k.name]["launches"] for k in ROUTE_KERNELS.values())


def check_counts(counts, names, path):
    """Every kernel in ``names`` launched; no plain version of any ran."""
    for name, c in counts.items():
        if (name in names and c["launches"] <= 0) or c["plain_calls"] != 0:
            fail(f"{path}: {name}: launches {c['launches']}, plain calls {c['plain_calls']}")


def phase_slice():
    from laser_tpu_torch import registry
    from laser_tpu_torch.models.transformer import (greedy_decode, init_transformer,
                                                    transformer_forward)

    print("phase 3: serving slice, 8L d2048 bf16", flush=True)
    params = init_transformer(0, dtype=torch.bfloat16, device=DEVICE, **MODEL)
    nbytes = sum(t.numel() * t.element_size() for t in
                 [params["embed"]] + [x for b in params["blocks"] for x in b.values()])
    print(f"  weights {nbytes / 1e9:.3f} GB", flush=True)
    prompts = traffic(MODEL["vocab"])
    serve(params, MODEL["n_heads"], prompts[:1])  # warm-up: cuBLAS handles, allocator
    registry.reset_counts()
    eng, outs, wall = serve(params, MODEL["n_heads"], prompts, keep_first_logits=True)
    counts = registry.counts()
    print(f"  counts {json.dumps(counts)}", flush=True)
    check_tokens(outs, MODEL["vocab"])
    check_counts(counts, SERVING_KERNELS, "serving")
    ntok = sum(len(o) for o in outs)
    print(f"  served {len(outs)} requests, {ntok} tokens in {wall:.3f} s: "
          f"{ntok / wall:.1f} tokens/s; stats {eng.stats}", flush=True)

    # first-token logits of two requests against the plain dense forward
    for i in (0, 1):
        ref = transformer_forward(params, torch.as_tensor(prompts[i][None], device=DEVICE).long(),
                                  n_heads=MODEL["n_heads"], plain=True)[0, -1].float().cpu()
        got = eng.first_logits[i]
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        print(f"  request {i} first-token logits vs plain: max_abs_err {err:.3e} "
              f"rel {rel:.3e} (bound {LOGITS_REL_BOUND:.0e})", flush=True)
        if not rel <= LOGITS_REL_BOUND:
            fail(f"request {i}: first-token logits rel err {rel:.3e}")

    same = total = 0
    for p, toks in zip(prompts, outs):
        want = greedy_decode(params, torch.as_tensor(p[None], device=DEVICE).long(),
                             n_heads=MODEL["n_heads"], max_new_tokens=NEW_TOKENS,
                             plain=True)[0, len(p):].tolist()
        same += sum(a == b for a, b in zip(toks, want))
        total += len(want)
    print(f"  token agreement with plain bf16 greedy_decode: {same}/{total} "
          f"({same / total:.4f})", flush=True)
    prof = profile_step(lambda: serve(params, MODEL["n_heads"], prompts), "engine run")
    return counts, {"wall_s": wall, "tokens": ntok, "tokens_per_s": ntok / wall,
                    "profile": prof}


def phase_f32():
    from laser_tpu_torch.models.transformer import greedy_decode, init_transformer

    print("phase 4: engine vs plain greedy_decode, 2L d512 f32", flush=True)
    params = init_transformer(1, dtype=torch.float32, device=DEVICE, **MODEL_F32)
    prompts = traffic(MODEL_F32["vocab"])
    _, outs, wall = serve(params, MODEL_F32["n_heads"], prompts)
    check_tokens(outs, MODEL_F32["vocab"])
    for i, (p, toks) in enumerate(zip(prompts, outs)):
        want = greedy_decode(params, torch.as_tensor(p[None], device=DEVICE).long(),
                             n_heads=MODEL_F32["n_heads"], max_new_tokens=NEW_TOKENS,
                             plain=True)[0, len(p):].tolist()
        if toks != want:
            first = next(j for j, (a, b) in enumerate(zip(toks, want)) if a != b)
            fail(f"f32 request {i}: engine and plain greedy differ from token {first}")
    print(f"  all {len(outs)} requests token-identical; engine wall {wall:.3f} s", flush=True)


def train_batch(vocab, shape, seed):
    toks = np.random.RandomState(seed).randint(0, vocab, size=shape)
    return torch.as_tensor(toks, device=DEVICE).long()


def transformer_loss(n_heads):
    """``loss(params, tokens, plain)`` of the transformer."""
    from laser_tpu_torch.models.transformer import transformer_lm_loss

    return lambda p, t, plain: transformer_lm_loss(p, t, n_heads=n_heads, plain=plain)


def llama_loss(cfg, **kw):
    """``loss(params, tokens, plain)`` of the llama model ``cfg``."""
    from laser_tpu_torch.models.llama import llama_lm_loss

    return lambda p, t, plain: llama_lm_loss(p, t, n_heads=cfg["n_heads"],
                                             n_kv_heads=cfg["n_kv_heads"], plain=plain, **kw)


def loss_and_grads(params, tokens, loss_fn, plain):
    from laser_tpu_torch.ops.optim import value_and_grad

    return value_and_grad(lambda p, t: loss_fn(p, t, plain))(params, tokens)


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def check_routes(params, tokens, loss_fn, loss_rel, grad_rel, norm: str):
    """Loss and every gradient leaf, kernel route vs plain route. ``norm``:
    "fro" compares ||a - b|| / ||b||, "max" max |a - b| / max |b|. The
    rope tables (llama) are not trained: their leaves are left out."""
    from laser_tpu_torch.ops.optim import tree_leaves

    static = {k: params[k] for k in ("rope_cos", "rope_sin") if k in params}
    params = {k: v for k, v in params.items() if k not in static}
    fn = (lambda p, t, plain: loss_fn({**p, **static}, t, plain)) if static else loss_fn
    lk, gk = loss_and_grads(params, tokens, fn, plain=False)
    lp, gp = loss_and_grads(params, tokens, fn, plain=True)
    rel = abs(lk.item() - lp.item()) / abs(lp.item())
    print(f"  loss kernel {lk.item():.6f} plain {lp.item():.6f} rel {rel:.3e} "
          f"(bound {loss_rel:.0e})", flush=True)
    if not (math.isfinite(lk.item()) and rel <= loss_rel):
        fail(f"loss rel err {rel:.3e}")
    worst = ("", 0.0)
    for name, a, b in zip(leaf_names(params), tree_leaves(gk), tree_leaves(gp), strict=True):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            fail(f"gradient {name} is not finite")
        if norm == "fro":
            r = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
        else:
            r = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, (name, r), key=lambda t: t[1])
        if not r <= grad_rel:
            fail(f"gradient {name}: rel err {r:.3e} > {grad_rel:.0e}")
    print(f"  {len(tree_leaves(gk))} gradient leaves within {grad_rel:.0e} ({norm}); "
          f"worst {worst[0]} {worst[1]:.3e}", flush=True)


def profile_step(step_fn, what: str = "step", require: bool = True):
    """One step (or engine run) under torch.profiler: device time by kernel,
    busy and idle share of its wall time. Device activity only: tracing
    every host op as well slows the host the idle share measures, and
    summarising a speculative run's host ops took minutes. A trace with no
    device time fails the run, or with ``require=False`` gives None."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies are the entries on the CUDA side; one stream, so
    # their times add up to the busy time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    if not rows:
        if require:
            fail("torch.profiler recorded no device time")
        print(f"  profiled {what}: the trace kept no device time", flush=True)
        return None
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    print(f"  profiled {what}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall_ms:.4f}", flush=True)
    for ms, n, key in rows[:16]:
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% {n:5d}x {key[:110]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "top": [{"ms": ms, "calls": n, "kernel": key[:160]} for ms, n, key in rows[:16]]}


def phase_train():
    from laser_tpu_torch import registry
    from laser_tpu_torch.models import transformer as tf

    print("phase 5: training slice, 8L d2048 bf16, batch 8x1024", flush=True)
    n_heads = MODEL["n_heads"]
    params = tf.init_transformer(0, dtype=torch.bfloat16, device=DEVICE, **MODEL)
    tokens = train_batch(MODEL["vocab"], TRAIN_BATCH, 0)
    check_routes(params, tokens, transformer_loss(n_heads), TRAIN_LOSS_REL, TRAIN_GRAD_REL,
                 "fro")
    torch.cuda.empty_cache()

    opt = tf.transformer_train_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_counts()
    with torch.no_grad():
        eval0 = tf.transformer_lm_loss(params, tokens, n_heads=n_heads).item()
    losses, times = [], []
    for step in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = tf.transformer_train_step(params, opt, tokens, step,
                                                      n_heads=n_heads, lr=LR, weight_decay=WD)
        losses.append(loss.item())  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        eval6 = tf.transformer_lm_loss(params, tokens, n_heads=n_heads).item()
    counts = registry.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  counts {json.dumps(counts)}", flush=True)
    check_counts(counts, TRAINING_KERNELS, "training")
    print(f"  step losses {[round(x, 5) for x in losses]}", flush=True)
    print(f"  eval loss before step 1 {eval0:.6f}, after step {TRAIN_STEPS} {eval6:.6f}",
          flush=True)
    if not (math.isfinite(eval0) and math.isfinite(eval6) and eval6 < eval0):
        fail(f"eval loss did not fall: {eval0} -> {eval6}")
    step_ms = statistics.median(times[1:])
    rows = TRAIN_BATCH[0] * (TRAIN_BATCH[1] - 1)
    print(f"  step ms (median of steps 2-{TRAIN_STEPS}) {step_ms:.2f} "
          f"(all {[round(t, 2) for t in times]}); {rows / step_ms * 1e3:.1f} training "
          f"tokens/s ({rows} target tokens per step); peak memory {peak_gb:.3f} GB",
          flush=True)
    prof = profile_step(lambda: tf.transformer_train_step(
        params, opt, tokens, TRAIN_STEPS + 1, n_heads=n_heads, lr=LR, weight_decay=WD))
    return counts, {"step_ms": step_ms, "step_ms_all": times, "tokens_per_step": rows,
                    "tokens_per_s": rows / step_ms * 1e3, "peak_gb": peak_gb,
                    "eval_loss": [eval0, eval6], "losses": losses, "profile": prof}


def phase_train_f32():
    from laser_tpu_torch.models import transformer as tf
    from laser_tpu_torch.ops.optim import tree_leaves

    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.gemm.kernel import ROUTE_KERNELS

    print("phase 6: f32 train step, kernels vs plain, 2L d512", flush=True)
    n_heads = MODEL_F32["n_heads"]
    params = tf.init_transformer(1, dtype=torch.float32, device=DEVICE, **MODEL_F32)
    tokens = train_batch(MODEL_F32["vocab"], TRAIN_F32_BATCH, 1)
    check_routes(params, tokens, transformer_loss(n_heads), F32_LOSS_REL, F32_GRAD_REL, "max")
    # the kernel route alone, counted: its products (M 1024 rows, the
    # backward's transposed operands) on the simt route, no plain GEMM
    registry.reset_counts()
    loss_and_grads(params, tokens, transformer_loss(n_heads), plain=False)
    torch.cuda.synchronize()
    counts = registry.counts()
    print(f"  the kernel route's loss and gradients, counted: "
          f"{json.dumps({k: v for k, v in counts.items() if any(v.values())})}", flush=True)
    if counts["gemm_simt"]["launches"] == 0 or any(
            counts[k.name]["plain_calls"] for k in ROUTE_KERNELS.values()):
        fail(f"f32 train step: gemm_simt never launched or a plain GEMM ran: {counts}")
    # Adam's first step moves each element by about lr whatever the size of
    # its gradient, so an element whose gradient lies within the summation
    # error of zero may step the other way: max |delta| <= 2 lr, mean
    # |delta| <= 1e-3 lr
    pk, pp = (tf.init_transformer(1, dtype=torch.float32, device=DEVICE, **MODEL_F32)
              for _ in range(2))  # the same seed: two copies of ``params``
    _, _, lk = tf.transformer_train_step(pk, tf.transformer_train_init(pk), tokens, 1,
                                         n_heads=n_heads, lr=LR, weight_decay=WD)
    _, _, lp = tf.transformer_train_step(pp, tf.transformer_train_init(pp), tokens, 1,
                                         n_heads=n_heads, lr=LR, weight_decay=WD, plain=True)
    if not abs(lk.item() - lp.item()) <= F32_LOSS_REL * abs(lp.item()):
        fail(f"f32 train step loss {lk.item()} vs plain {lp.item()}")
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(pk), tree_leaves(pp))])
    dmax, dmean = d.max().item(), d.mean().item()
    flipped = int((d > LR / 2).sum().item())
    print(f"  updated params: max |delta| {dmax:.3e} (bound {2 * LR:.1e}), mean "
          f"{dmean:.3e} (bound {1e-3 * LR:.1e}), {flipped} of {d.numel()} elements "
          f"differ by more than lr/2", flush=True)
    if not (dmax <= 2 * LR and dmean <= 1e-3 * LR):
        fail("f32 updated params outside the Adam-aware bound")

    from laser_tpu_torch.models.llama import init_llama

    print("  llama: 2L d512, 8 q heads over 2 kv heads, vocab 8192, the chunked loss "
          "(memory_budget_bytes=None)", flush=True)
    params = init_llama(1, dtype=torch.float32, device=DEVICE, max_len=TRAIN_F32_BATCH[1],
                        **LLAMA_F32)
    tokens = train_batch(LLAMA_F32["vocab"], TRAIN_F32_BATCH, 2)
    registry.reset_counts()
    check_routes(params, tokens, llama_loss(LLAMA_F32, memory_budget_bytes=None),
                 F32_LOSS_REL, F32_GRAD_REL, "max")
    counts = registry.counts()
    for name in LLAMA_TRAIN_F32_KERNELS:
        if counts[name]["launches"] == 0:
            fail(f"f32 llama loss: {name} never launched")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def dequantized(params, eng_params):
    """``params`` with the engine's int4 block weights dequantized to the
    params' dtype: the dense model the quantized engine computes."""
    from laser_tpu_torch.ops.gemm.int4_kernel import dequantize_int4

    dt = params["embed"].dtype
    return dict(params, blocks=[{k: dequantize_int4(w).to(dt) if isinstance(w, dict) else w
                                 for k, w in blk.items()} for blk in eng_params["blocks"]])


def plain_generate(params, prompts, n_heads, n_kv_heads):
    from laser_tpu_torch.models.llama import llama_generate

    return [llama_generate(params, torch.as_tensor(p[None], device=DEVICE), n_heads=n_heads,
                           n_kv_heads=n_kv_heads, max_new_tokens=NEW_TOKENS,
                           plain=True)[0, len(p):].tolist() for p in prompts]


def agreement(outs, wants):
    same = sum(a == b for o, w in zip(outs, wants) for a, b in zip(o, w))
    return same, sum(len(w) for w in wants)


def phase_llama():
    from laser_tpu_torch import registry
    from laser_tpu_torch.models.llama import init_llama, llama_forward
    from laser_tpu_torch.ops.rope import rope_tables

    H, Hkv, vocab = LLAMA["n_heads"], LLAMA["n_kv_heads"], LLAMA["vocab"]
    print("phase 7: llama serving, Llama-3-8B widths, 8 layers bf16", flush=True)
    params = init_llama(0, dtype=torch.bfloat16, device=DEVICE, max_len=LLAMA_ROPE["max_len"],
                        **LLAMA)
    params["rope_cos"], params["rope_sin"] = rope_tables(
        LLAMA_ROPE["max_len"], LLAMA["d_model"] // H, base=LLAMA_ROPE["base"], device=DEVICE)
    prompts = traffic(vocab)
    counts_by_run, results, outs_a = {}, {}, None
    for tag, quant in (("llama", {}), ("llama_int4", dict(**LLAMA_INT4, kv_quant=True))):
        print(f"  run {tag} {quant}", flush=True)
        serve(params, H, prompts[:1], model="llama", **quant)  # warm-up
        registry.reset_counts()
        eng, outs, wall = serve(params, H, prompts, keep_first_logits=True, model="llama",
                                **quant)
        counts = registry.counts()
        print(f"  counts {json.dumps(counts)}", flush=True)
        check_tokens(outs, vocab)
        check_counts(counts, LLAMA_KERNELS[tag], tag)
        ntok = sum(len(o) for o in outs)
        wbytes = tree_bytes(eng.params["blocks"]) + tree_bytes(
            [params["embed"], params["unembed"]])
        print(f"  served {len(outs)} requests, {ntok} tokens in {wall:.3f} s: "
              f"{ntok / wall:.1f} tokens/s; weights {wbytes / 1e9:.3f} GB (blocks "
              f"{tree_bytes(eng.params['blocks']) / 1e9:.3f} GB); stats {eng.stats}",
              flush=True)
        ref = dequantized(params, eng.params) if quant else params
        for i in (0, 1):
            want = llama_forward(ref, torch.as_tensor(prompts[i][None], device=DEVICE),
                                 n_heads=H, n_kv_heads=Hkv, plain=True)[0, -1].float().cpu()
            err = (eng.first_logits[i] - want).abs().max().item()
            rel = err / want.abs().max().item()
            print(f"  request {i} first-token logits vs plain llama_forward: max_abs_err "
                  f"{err:.3e} rel {rel:.3e} (bound {LOGITS_REL_BOUND:.0e})", flush=True)
            if not rel <= LOGITS_REL_BOUND:
                fail(f"{tag} request {i}: first-token logits rel err {rel:.3e}")
        plain = plain_generate(ref, prompts, H, Hkv)
        del ref, eng
        same, total = agreement(outs, plain)
        firsts = sum(o[0] == w[0] for o, w in zip(outs, plain))
        print(f"  token agreement with the plain bf16 llama_generate on "
              f"{'the dequantized' if quant else 'the same'} weights: {same}/{total} "
              f"({same / total:.4f}); first tokens {firsts}/{len(outs)}", flush=True)
        agree = {"plain": [same, total], "plain_first": [firsts, len(outs)]}
        if outs_a is None:
            outs_a = outs
        else:
            same, total = agreement(outs, outs_a)
            print(f"  token agreement with run llama (bf16 weights, bf16 pages): "
                  f"{same}/{total} ({same / total:.4f})", flush=True)
            agree["run_llama"] = [same, total]
        prof = profile_step(lambda: serve(params, H, prompts, model="llama", **quant),
                            "engine run")
        torch.cuda.empty_cache()
        counts_by_run[tag] = counts
        results[tag] = {"wall_s": wall, "tokens": ntok, "tokens_per_s": ntok / wall,
                        "weight_bytes": wbytes, "agreement": agree, "profile": prof}
    return counts_by_run, results


def phase_llama_f32():
    from laser_tpu_torch.models.llama import init_llama

    H, Hkv, vocab = LLAMA_F32["n_heads"], LLAMA_F32["n_kv_heads"], LLAMA_F32["vocab"]
    print("phase 8: llama engine vs plain llama_generate, 2L d512 f32", flush=True)
    params = init_llama(1, dtype=torch.float32, device=DEVICE,
                        max_len=SERVE_CFG["max_pages_per_seq"] * SERVE_CFG["page_size"],
                        **LLAMA_F32)
    prompts = traffic(vocab)
    dense = plain_generate(params, prompts, H, Hkv)
    for tag, quant in (("unquantized", {}), ("int4 weights", LLAMA_INT4),
                       ("int8 KV pages", dict(kv_quant=True))):
        eng, outs, wall = serve(params, H, prompts, model="llama", **quant)
        check_tokens(outs, vocab)
        wants = plain_generate(dequantized(params, eng.params), prompts, H, Hkv) \
            if "weight_quant" in quant else dense
        same, total = agreement(outs, wants)
        print(f"  {tag}: {same}/{total} tokens equal to plain llama_generate; engine wall "
              f"{wall:.3f} s", flush=True)
        if quant.get("kv_quant"):
            if any(o[0] != w[0] for o, w in zip(outs, wants)):
                fail(f"f32 llama {tag}: a first token differs from plain llama_generate")
        elif same != total:
            i, first = next((i, j) for i, (o, w) in enumerate(zip(outs, wants))
                            for j, (a, b) in enumerate(zip(o, w)) if a != b)
            fail(f"f32 llama {tag} request {i}: engine and plain differ from token {first}")


def spec_runs(tag, params, n_heads, prompts, vocab, new_tokens, cfg, draft_quant,
              profile_tokens, model="transformer"):
    """The plain burst engine, then the speculative engine with the
    quantized self-draft, each warmed up, counted and checked, then run once
    more under torch.profiler with ``profile_tokens`` new tokens per request
    (a shorter run, to keep the script's time down)."""
    from laser_tpu_torch import registry

    counts_by_run, results, outs_by_run = {}, {}, {}
    for run, kw in ((f"{tag}_plain", dict(spec_gamma=0)),
                    (f"{tag}_spec", dict(spec_gamma=SPEC_GAMMA, draft_weight_quant=draft_quant))):
        draft = params if kw["spec_gamma"] else None
        print(f"  run {run} {kw}", flush=True)
        serve(params, n_heads, prompts[:1], model=model, cfg=cfg, new_tokens=8, draft=draft,
              **kw)  # warm-up
        registry.reset_counts()
        eng, outs, wall = serve(params, n_heads, prompts, model=model, cfg=cfg,
                                new_tokens=new_tokens, draft=draft, **kw)
        counts = registry.counts()
        print(f"  counts {json.dumps(counts)}", flush=True)
        check_tokens(outs, vocab, new_tokens)
        check_counts(counts, SPEC_KERNELS[run], run)
        ntok = sum(len(o) for o in outs)
        res = {"wall_s": wall, "tokens": ntok, "tokens_per_s": ntok / wall, "stats": eng.stats}
        if kw["spec_gamma"]:
            st = eng.stats
            res["alpha"] = (st["spec_tokens"] / st["spec_live_rounds"] - 1) / SPEC_GAMMA
        print(f"  served {len(outs)} requests, {ntok} tokens in {wall:.3f} s: "
              f"{ntok / wall:.1f} tokens/s"
              + (f"; alpha {res['alpha']:.4f}" if "alpha" in res else "")
              + f"; stats {eng.stats}", flush=True)
        del eng
        res["profile"] = profile_step(lambda: serve(
            params, n_heads, prompts, model=model, cfg=cfg, new_tokens=profile_tokens,
            draft=draft, **kw), f"{run} engine run, {profile_tokens} new tokens per request")
        counts_by_run[run], results[run], outs_by_run[run] = counts, res, outs
    plain, spec = results[f"{tag}_plain"], results[f"{tag}_spec"]
    spec["speed_vs_plain"] = spec["tokens_per_s"] / plain["tokens_per_s"]
    same, total = agreement(outs_by_run[f"{tag}_spec"], outs_by_run[f"{tag}_plain"])
    spec["agreement_with_plain"] = [same, total]
    print(f"  speculative / plain burst engine: {spec['speed_vs_plain']:.3f}x; token "
          f"agreement {same}/{total} ({same / total:.4f}; bf16 near-ties between the "
          f"verify and decode numerics may flip an argmax: printed, not gated)", flush=True)
    torch.cuda.empty_cache()
    return counts_by_run, results


def phase_spec_s1():
    from laser_tpu_torch.models.transformer import init_transformer

    print("phase 9: speculative serving S1, 8L d2048 bf16, int8 self-draft", flush=True)
    params = init_transformer(0, dtype=torch.bfloat16, device=DEVICE, **MODEL)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, MODEL["vocab"], size=S1_TRAFFIC["prompt"]).astype(np.int32)
               for _ in range(S1_TRAFFIC["n"])]
    return spec_runs("s1", params, MODEL["n_heads"], prompts, MODEL["vocab"],
                     S1_TRAFFIC["new"], S1_CFG, "int8", profile_tokens=64)


def phase_spec_s2():
    from laser_tpu_torch.models.llama import init_llama
    from laser_tpu_torch.ops.rope import rope_tables

    H = LLAMA["n_heads"]
    print("phase 10: speculative serving S2, Llama-3-8B widths, 8 layers bf16, int4 "
          "self-draft, int8 pages", flush=True)
    params = init_llama(0, dtype=torch.bfloat16, device=DEVICE, max_len=LLAMA_ROPE["max_len"],
                        **LLAMA)
    params["rope_cos"], params["rope_sin"] = rope_tables(
        LLAMA_ROPE["max_len"], LLAMA["d_model"] // H, base=LLAMA_ROPE["base"], device=DEVICE)
    return spec_runs("s2", params, H, traffic(LLAMA["vocab"]), LLAMA["vocab"], NEW_TOKENS,
                     S2_CFG, "int4", profile_tokens=16, model="llama")


def phase_spec_f32():
    from laser_tpu_torch.models.llama import init_llama
    from laser_tpu_torch.models.transformer import greedy_decode, init_transformer

    print("phase 11: speculative engine vs plain engine and dense reference, f32", flush=True)
    cap = SERVE_CFG["max_pages_per_seq"] * SERVE_CFG["page_size"]
    tparams = init_transformer(1, dtype=torch.float32, device=DEVICE, **MODEL_F32)
    lparams = init_llama(1, dtype=torch.float32, device=DEVICE, max_len=cap, **LLAMA_F32)
    families = {
        "transformer": (tparams, MODEL_F32["n_heads"], [
            ("self-draft", tparams, None, {}),
            ("smaller different draft",
             init_transformer(2, dtype=torch.float32, device=DEVICE, **DRAFT_F32),
             DRAFT_F32["n_heads"], {})]),
        "llama": (lparams, LLAMA_F32["n_heads"], [
            ("int4 self-draft", lparams, None, dict(draft_weight_quant="int4")),
            ("smaller different draft",
             init_llama(2, dtype=torch.float32, device=DEVICE, max_len=cap, **LLAMA_DRAFT_F32),
             LLAMA_DRAFT_F32["n_heads"], {}),
            ("self-draft, int8 pages", lparams, None, dict(kv_quant=True))]),
    }
    prompts = traffic(MODEL_F32["vocab"])
    for model, (params, H, drafts) in families.items():
        if model == "llama":
            dense = plain_generate(params, prompts, H, LLAMA_F32["n_kv_heads"])
        else:
            dense = [greedy_decode(params, torch.as_tensor(p[None], device=DEVICE).long(),
                                   n_heads=H, max_new_tokens=NEW_TOKENS,
                                   plain=True)[0, len(p):].tolist() for p in prompts]
        plain_by_kv = {}
        for tag, draft, dh, kw in drafts:
            kvq = kw.get("kv_quant", False)
            if kvq not in plain_by_kv:
                plain_by_kv[kvq] = serve(params, H, prompts, model=model, cfg=SPEC_F32_CFG,
                                         kv_quant=kvq)[1]
            _, outs, wall = serve(params, H, prompts, model=model, cfg=SPEC_F32_CFG,
                                  draft=draft, draft_n_heads=dh, spec_gamma=SPEC_GAMMA, **kw)
            check_tokens(outs, MODEL_F32["vocab"])
            same, total = agreement(outs, plain_by_kv[kvq])
            dsame, _ = agreement(outs, dense)
            print(f"  {model} {tag}: {same}/{total} tokens equal to the plain engine, "
                  f"{dsame}/{total} to the dense reference; engine wall {wall:.3f} s",
                  flush=True)
            # int8 pages store K/V with an error the dense reference lacks
            if same != total or (not kvq and dsame != total):
                fail(f"f32 {model} speculative {tag}: tokens differ")


def cudnn_forward(params, x):
    """C1's forward on PyTorch's own operators (cuDNN convolutions, cuBLAS
    products, TF32 off): the yardstick the kernel route is held against."""
    h = x
    for layer in params[:-2]:
        h = F.avg_pool2d(F.relu(F.conv2d(h, layer["w"], layer["b"], padding=1)), 2)
    h = F.relu(torch.addmm(params[-2]["b"], h.flatten(1), params[-2]["w"]))
    return torch.addmm(params[-1]["b"], h, params[-1]["w"])


def images_per_s(fn) -> float:
    """Images per second: the median of CNN_FORWARDS synchronised forwards."""
    times = []
    for _ in range(CNN_FORWARDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return CNN_BATCH / statistics.median(times)


def phase_cnn():
    from laser_tpu_torch import registry
    from laser_tpu_torch.models.cnn import cnn_forward, cnn_predict, init_cnn, mean_pool2x2
    from laser_tpu_torch.models.mlp import init_mlp, mlp_predict
    from laser_tpu_torch.ops.conv import conv2d_direct

    print("phase 12: CNN slice C1, f32, 16 images at 224x224, 1000 classes", flush=True)
    params = init_cnn(0, dtype=torch.float32, device=DEVICE, **CNN)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(12)
    hw = CNN["image_hw"]
    x = torch.randn((CNN_BATCH, CNN["in_channels"], hw, hw), generator=g, device=DEVICE)
    with torch.no_grad():
        cnn_predict(params, x)  # warm-up
        torch.cuda.synchronize()
        registry.reset_counts()
        probs = cnn_predict(params, x)
        torch.cuda.synchronize()
        counts = registry.counts()
        print(f"  counts {json.dumps(counts)}", flush=True)
        for name, c in counts.items():
            if c["launches"] != CNN_LAUNCHES.get(name, 0) or c["plain_calls"]:
                fail(f"cnn: {name}: launches {c['launches']} (want "
                     f"{CNN_LAUNCHES.get(name, 0)}), plain calls {c['plain_calls']}")
        if probs.shape != (CNN_BATCH, CNN["num_classes"]) or not torch.isfinite(probs).all():
            fail(f"cnn: probabilities of shape {tuple(probs.shape)} or not finite")
        dev_sum = (probs.double().sum(-1) - 1).abs().max().item()
        print(f"  rows sum to 1 within {dev_sum:.3e} (bound {PROB_SUM_TOL:.0e})", flush=True)
        if not dev_sum <= PROB_SUM_TOL:
            fail(f"cnn: a row of probabilities sums to 1 +- {dev_sum:.3e}")
        logits = cnn_forward(params, x)
        arg = logits.argmax(-1)
        if not torch.equal(probs.argmax(-1), arg):
            fail("cnn: argmax of the probabilities differs from that of the logits")
        for what, want in (("plain route", cnn_forward(params, x, plain=True)),
                           ("cuDNN, TF32 off", cudnn_forward(params, x))):
            err, rel = rel_error(logits, want)
            same = torch.equal(arg, want.argmax(-1))
            print(f"  logits vs {what}: max_abs_err {err:.3e} rel {rel:.3e} (bound "
                  f"{CNN_LOGITS_REL:.0e}); argmax identical: {same}", flush=True)
            if not (rel <= CNN_LOGITS_REL and same):
                fail(f"cnn: logits vs {what}: rel {rel:.3e}, argmax identical {same}")
        ips = images_per_s(lambda: cnn_predict(params, x))
        lib_ips = images_per_s(lambda: torch.softmax(cudnn_forward(params, x), -1))
        print(f"  cnn_predict {ips:.1f} images/s; the same forward on cuDNN/cuBLAS "
              f"{lib_ips:.1f} images/s (median of {CNN_FORWARDS}, synchronised)", flush=True)
        n = CNN_PROFILE_FORWARDS
        prof = profile_step(lambda: [cnn_predict(params, x) for _ in range(n)],
                            f"{n} cnn_predict forwards")
        recorded = sum(r["calls"] for r in prof["top"])
        print(f"  {recorded} device kernels recorded of {CNN_DEVICE_KERNELS * n} launched; "
              f"per forward: wall {prof['wall_ms'] / n:.3f} ms, device busy "
              f"{prof['busy_ms'] / n:.3f} ms", flush=True)
        prof["kernels_recorded"] = [recorded, CNN_DEVICE_KERNELS * n]

        # the MLP head on the conv trunk's flattened features
        feats = x
        for layer in params[:-2]:
            feats = conv2d_direct(feats, layer["w"], padding=(1, 1))
            feats = mean_pool2x2(torch.relu(feats + layer["b"][None, :, None, None]))
        feats = feats.flatten(1)
        dims = [feats.shape[1], CNN["hidden"], CNN["num_classes"]]
        mlp = init_mlp(1, dims, device=DEVICE)
        registry.reset_counts()
        mprobs = mlp_predict(mlp, feats)
        torch.cuda.synchronize()
        mlp_counts = registry.counts()
        msum = (mprobs.double().sum(-1) - 1).abs().max().item()
        print(f"  mlp_predict {dims}: rows sum to 1 within {msum:.3e}; counts "
              f"{json.dumps({k: v for k, v in mlp_counts.items() if v['launches']})}",
              flush=True)
        if (gemm_launches(mlp_counts) != 2 or mlp_counts["softmax_vec"]["launches"] != 1
                or any(c["plain_calls"] for c in mlp_counts.values())
                or not msum <= PROB_SUM_TOL):
            fail(f"mlp: counts {mlp_counts}, row sums within {msum:.3e}")
    return {"cnn": counts, "mlp": mlp_counts}, {
        "images_per_s": ips, "cudnn_images_per_s": lib_ips, "profile": prof}


# ---------------------------------------------------------------------------
# Phase 13: the primitives path (for_each, for_each_multi, row_reduce,
# map_reduce and what is built on them) at bench.py's shapes
# ---------------------------------------------------------------------------

# stated bounds, kernel vs plain version on the same card tensors; the
# elementwise ones hold each element against max(|plain|, 1):
# the accurate tier's cores ("exact"): the same bits, as the plain version
# is the same polynomial rounded op by op
# f32 elementwise (+ - * /, libm sinf/expf)
PRIM_F32_REL = 1e-6
# the fast tier: CUDA's intrinsics against torch's function: __expf is
# 2 + floor(|1.173 x|) ulp, 1.3e-5 at 88
PRIM_FAST_REL = 2e-5
# bf16 outputs: one bf16 rounding
PRIM_BF16_REL = 2.0 ** -7
# sums: |d| <= 1e-6 * sum |mapped|, summation order only
PRIM_SUM_REL = 1e-6
# the f32 GEMM of relu(a @ b + bias): summation order over K = 2048
PRIM_GEMM_REL = 1e-5
PRIM_REPS = 20


@dataclasses.dataclass
class Prim:
    name: str          # the kernel record
    slot: str          # "" for the record's main case
    shape: str
    run: Callable      # the kernel path on fresh inputs (counted once)
    plain: Callable    # its plain version on the same inputs
    nbytes: float      # each input read once, each output written once
    flops: float
    check: str         # "exact", "rel", "fast", "bf16", "sum" or "gemm"
    time_run: Optional[Callable] = None   # the kernel for timing (donated buffers)
    library: Optional[Callable] = None
    library_call: Optional[str] = None
    sum_abs: Optional[Callable] = None    # sum |mapped| of a "sum" check
    repeat: bool = False                  # a reduction: two runs bit-identical
    dtype: torch.dtype = torch.float32


# operations per element counted for a body's node (1) and for a
# vector-math core or a libm call (20: a degree-5 polynomial and its range
# reduction); memory bounds them all by far
CORE_OPS = 20


def prim_cases():
    from laser_tpu_torch import lux
    from laser_tpu_torch.ops import foreach as fe
    from laser_tpu_torch.ops import reductions as R
    from laser_tpu_torch.ops.gemm import gemm_reference
    from laser_tpu_torch.ops import vector_math as vm

    g = torch.Generator(device=DEVICE)
    g.manual_seed(13)

    def rnd(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * std).to(dtype)

    big, mid, rows = (8192, 8192), (4096, 4096), (8192, 4096)
    n_big, n_mid, n_rows = 8192 * 8192, 4096 * 4096, 8192 * 4096
    xs = rnd(*big, std=4.0)
    xpos = xs.abs() + 1e-3
    a, b, c = rnd(*mid), rnd(*mid), rnd(*mid)
    ra, rb = rnd(*rows), rnd(*rows)
    xb = rnd(*big, dtype=torch.bfloat16, std=4.0)
    yb, zb = rnd(*big, dtype=torch.bfloat16), rnd(*big, dtype=torch.bfloat16)
    ga, gb, gbias = rnd(4096, 2048), rnd(2048, 2048, std=2048 ** -0.5), rnd(2048)
    xyz = lambda x, y, z: x + y - torch.sin(z)  # noqa: E731  bench.py:293's body
    cases = []

    def vm_case(name, algo, x, check, library, slot, donate=False, dtype=torch.float32):
        body = vm.pick(name, algo)
        isz = x.element_size()
        tbuf = x.clone() if donate else x
        kern = getattr(vm, name)
        cases.append(Prim(
            name="for_each", slot=slot, shape="x".join(map(str, x.shape)),
            run=lambda: kern(x.clone() if donate else x, algorithm=algo, donate=donate),
            plain=lambda: fe.for_each_reference(body, x),
            time_run=lambda: kern(tbuf, algorithm=algo, donate=donate),
            nbytes=2 * x.numel() * isz, flops=CORE_OPS * x.numel(), check=check,
            library=lambda: library(x), library_call=f"torch.{library.__name__}",
            dtype=dtype))

    vm_case("exp", "accurate", xs, "exact", torch.exp, "exp_accurate_donate", donate=True)
    vm_case("exp", "fast", xs, "fast", torch.exp, "exp_fast_donate", donate=True)
    vm_case("log", "fast", xpos, "fast", torch.log, "log_fast")
    vm_case("tanh", "fast", xs, "fast", torch.tanh, "tanh_fast")
    vm_case("sigmoid", "fast", xs, "fast", torch.sigmoid, "sigmoid_fast")
    ta = a.clone()
    cases.append(Prim(
        "for_each", "", "4096x4096 x3, x + y - sin z, donate",
        run=lambda: fe.for_each(xyz, a.clone(), b, c, donate=True),
        plain=lambda: fe.for_each_reference(xyz, a, b, c),
        time_run=lambda: fe.for_each(xyz, ta, b, c, donate=True),
        nbytes=4 * n_mid * 4, flops=(2 + CORE_OPS) * n_mid, check="rel",
        library=lambda: a + b - torch.sin(c), library_call="eager x + y - torch.sin(z)"))
    pm = lambda x, y: (x + y, x - y)  # noqa: E731
    cases.append(Prim(
        "for_each_multi", "", "4096x4096 x2 -> (x + y, x - y)",
        run=lambda: fe.for_each_multi(pm, a, b), plain=lambda: fe.for_each_multi_reference(pm, a, b),
        nbytes=4 * n_mid * 4, flops=2 * n_mid, check="rel",
        library=lambda: (a + b, a - b), library_call="eager x + y, x - y"))
    cases.append(Prim(
        "map_reduce", "", "8192x8192 reduce_sum",
        run=lambda: R.reduce_sum(xs),
        plain=lambda: fe.map_reduce_reference(lambda t: t, xs),
        nbytes=n_big * 4, flops=n_big, check="sum", sum_abs=lambda: xs.abs().sum().item(),
        repeat=True, library=lambda: torch.sum(xs), library_call="torch.sum"))
    comb = lambda p: p.sum()  # noqa: E731
    cases.append(Prim(
        "map_reduce", "combine_fn", "8192x8192, per-block partials + combine_fn in torch",
        run=lambda: fe.map_reduce(lambda t: t, xs, combine_fn=comb),
        plain=lambda: fe.map_reduce_reference(lambda t: t, xs, combine_fn=comb),
        nbytes=n_big * 4, flops=n_big, check="sum", sum_abs=lambda: xs.abs().sum().item(),
        repeat=True, library=lambda: torch.sum(xs), library_call="torch.sum"))
    cases.append(Prim(
        "row_reduce", "", "8192x4096 row_reduce(exp, sum)",
        run=lambda: fe.row_reduce(torch.exp, ra),
        plain=lambda: fe.row_reduce_reference(torch.exp, ra),
        nbytes=n_rows * 4 + 8192 * 4, flops=(CORE_OPS + 1) * n_rows, check="sum",
        sum_abs=lambda: torch.exp(ra).sum(-1), repeat=True,
        library=lambda: torch.exp(ra).sum(-1), library_call="torch.exp(x).sum(-1)"))
    lx = lux.generate(lambda p, q, r: p + q - lux.lux_sin(r))
    cases.append(Prim(
        "for_each", "lux_xyz", "Lux a + b - lux_sin(c), 4096x4096",
        run=lambda: lx(a, b, c), plain=lambda: fe.for_each_reference(xyz, a, b, c),
        nbytes=4 * n_mid * 4, flops=(2 + CORE_OPS) * n_mid, check="rel",
        library=lambda: a + b - torch.sin(c), library_call="eager x + y - torch.sin(z)"))
    lr = lux.generate(lambda p, q: lux.lux_sum(p * q, axis=-1))
    cases.append(Prim(
        "row_reduce", "lux_sum_axis", "Lux lux_sum(a * b, axis=-1), 8192x4096",
        run=lambda: lr(ra, rb), plain=lambda: fe.row_reduce_reference(lambda p, q: p * q, ra, rb),
        nbytes=2 * n_rows * 4 + 8192 * 4, flops=2 * n_rows, check="sum",
        sum_abs=lambda: (ra * rb).abs().sum(-1), repeat=True,
        library=lambda: (ra * rb).sum(-1), library_call="(a * b).sum(-1)"))
    lg = lux.generate(lambda p, q, r: lux.lux_relu(p @ q + r))
    cases.append(Prim(
        "lux_gemm", "", "Lux relu(a @ b + bias), M4096 K2048 N2048",
        run=lambda: lg(ga, gb, gbias),
        plain=lambda: gemm_reference(ga, gb, bias=gbias, epilogue="relu"),
        nbytes=(4096 * 2048 * 2 + 2048 * 2048 + 2048) * 4, flops=2 * 4096 * 2048 * 2048,
        check="gemm", library=lambda: torch.relu(torch.addmm(gbias, ga, gb)),
        library_call="torch.relu(torch.addmm(bias, a, b))"))
    cases.append(Prim(
        "for_each", "bf16_xyz", "bf16 8192x8192 x3, x + y - sin z",
        run=lambda: fe.for_each(xyz, xb, yb, zb), plain=lambda: fe.for_each_reference(xyz, xb, yb, zb),
        nbytes=4 * n_big * 2, flops=(2 + CORE_OPS) * n_big, check="bf16",
        library=lambda: xb + yb - torch.sin(zb), library_call="eager x + y - torch.sin(z)",
        dtype=torch.bfloat16))
    vm_case("exp", "accurate", xb, "exact", torch.exp, "bf16_exp_accurate", dtype=torch.bfloat16)
    return cases


def prim_check(case: Prim, got, want) -> float:
    """The case's stated bound, kernel vs plain; returns max |d|."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for gt, wt in zip(got, want, strict=True):
        if gt.shape != wt.shape:
            fail(f"{case.name} {case.slot}: shape {tuple(gt.shape)} vs {tuple(wt.shape)}")
        d = (gt.double() - wt.double()).abs()
        fin = torch.isfinite(wt.double())
        if not torch.equal(torch.isfinite(gt.double()), fin):
            fail(f"{case.name} {case.slot}: finite where the plain version is not, or back")
        err = d[fin].max().item() if fin.any() else 0.0
        ref = wt.double()[fin].abs()
        per_elem = (d[fin] / ref.clamp(min=1.0)).max().item() if fin.any() else 0.0
        if case.check == "exact":  # elements whose bits differ (NaN matches NaN)
            same = (gt == wt) | (torch.isnan(gt) & torch.isnan(wt))
            rel, bound_ = float((~same).sum().item()), 0.0
        elif case.check == "rel":
            rel, bound_ = per_elem, PRIM_F32_REL
        elif case.check == "fast":
            rel, bound_ = per_elem, PRIM_FAST_REL
        elif case.check == "bf16":
            rel, bound_ = per_elem, PRIM_BF16_REL
        elif case.check == "gemm":
            rel, bound_ = err / max(ref.max().item(), 1e-30), PRIM_GEMM_REL
        elif case.check == "sum":
            sa = case.sum_abs()
            rel = (d / torch.as_tensor(sa, device=d.device, dtype=torch.float64)).max().item()
            bound_ = PRIM_SUM_REL
        else:
            raise ValueError(case.check)
        print(f"  {case.name} {case.slot or 'main'} [{case.shape}]: max_abs_err {err:.3e}, "
              f"{case.check} {rel:.3e} (bound {bound_:.0e})", flush=True)
        if not rel <= bound_:
            fail(f"{case.name} {case.slot}: {case.check} error {rel:.3e} > {bound_:.0e}")
        worst = max(worst, err)
    return worst


def _same_bits(a, b) -> bool:
    """Two results (a tensor, a tuple or a dict of them) are the same bits."""
    a = a if isinstance(a, (tuple, dict)) else (a,)
    b = b if isinstance(b, (tuple, dict)) else (b,)
    if isinstance(a, dict):
        a, b = tuple(a.values()), tuple(b.values())
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def check_and_time(spec, cases, outs, check):
    """Each case's first result (``outs``) held to its bound by
    ``check(case, got) -> max abs error``; a reduction run again must give
    the same bits; then the kernel (one call between two events, and 20 in a
    row), the plain version and the library call (one call, and 20 in a
    row) timed beside the bound.
    Returns the record entries by kernel name (a slot's under its name)."""
    entries = {}
    for case, got in zip(cases, outs):
        err = check(case, got)
        if case.repeat:
            again = case.run()
            torch.cuda.synchronize()
            same = _same_bits(got, again)
            print(f"    run to run bit-identical: {same}", flush=True)
            if not same:
                fail(f"{case.name} {case.slot}: two runs differ")
        kern = case.time_run or case.run
        ms, pms = cuda_ms(kern, reps=PRIM_REPS), cuda_ms(case.plain, reps=5)
        batched = cuda_batched_ms(kern)
        lms = cuda_ms(case.library, reps=PRIM_REPS) if case.library else None
        lbatched = cuda_batched_ms(case.library) if case.library else None
        peak = getattr(case, "peak", 0.0) or (
            spec.bf16_tflops if case.dtype == torch.bfloat16 else spec.f32_tflops)
        t_ops = case.flops / (peak * 1e12) * 1e3
        t_bytes = case.nbytes / (spec.hbm_gbps * 1e9) * 1e3
        bms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        lib = "none" if lms is None else f"{lms:.4f} ms ({lbatched:.4f} ms 20 in a row)"
        print(f"    time: kernel {ms:.4f} ms ({batched:.4f} ms per call of 20 in a row), "
              f"plain {pms:.4f} ms, library {lib} ({case.library_call}), "
              f"bound {bms:.4f} ms ({by}, {case.nbytes / 1e6:.1f} MB)", flush=True)
        entry = {"shape": case.shape, "max_abs_err": err, "ms": ms, "batched_ms": batched,
                 "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms,
                 "library_batched_ms": lbatched, "library_call": case.library_call}
        if case.slot:
            entries.setdefault(case.name, {})[case.slot] = entry
        else:
            entries[case.name] = {**entry, **entries.get(case.name, {})}
    return entries


def prim_sources():
    """The generated sources of phase 13's bodies, to build them together."""
    from laser_tpu_torch.ops import foreach as fe
    from laser_tpu_torch.ops import vector_math as vm

    f32 = torch.empty((8,), device=DEVICE)
    bf = f32.bfloat16()
    xyz = lambda x, y, z: x + y - torch.sin(z)  # noqa: E731
    srcs = [fe.for_each_source(vm.pick(n, t), f32) for n, t in
            (("exp", "accurate"), ("exp", "fast"), ("log", "fast"), ("tanh", "fast"),
             ("sigmoid", "fast"))]
    srcs += [fe.for_each_source(xyz, f32, f32, f32), fe.for_each_source(xyz, bf, bf, bf),
             fe.for_each_source(vm.pick("exp", "accurate"), bf),
             fe.for_each_multi_source(lambda x, y: (x + y, x - y), f32, f32),
             fe.map_reduce_source(lambda t: t, f32),
             fe.row_reduce_source(torch.exp, f32.reshape(2, 4)),
             fe.row_reduce_source(lambda p, q: p * q, f32.reshape(2, 4), f32.reshape(2, 4))]
    return srcs


PRIM_KERNELS = ("for_each", "for_each_multi", "row_reduce", "map_reduce")
# paths traced together in phases 13 and 14: more launches than a late
# profiler session drops at its start (~18)
PATH_PROFILE_REPS = 3


def phase_primitives(spec):
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops import foreach  # noqa: F401  registers the records

    print("phase 13: primitives path at bench.py's shapes (for_each, for_each_multi, "
          "row_reduce, map_reduce, vector math, reductions, Lux)", flush=True)
    t0 = time.perf_counter()
    srcs = prim_sources()
    registry.load_generated_many(srcs)
    gb = registry.GEN_BUILDS
    print(f"  generated bodies: {len(set(srcs))} sources, {gb['built']} built in parallel "
          f"({gb['loaded']} loaded), {gb['seconds']:.1f} s of nvcc, "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    cases = prim_cases()
    torch.cuda.synchronize()
    registry.reset_counts()
    outs = [case.run() for case in cases]
    torch.cuda.synchronize()
    counts = registry.counts()
    print(f"  counts {json.dumps({k: v for k, v in counts.items() if any(v.values())})}",
          flush=True)
    for k in PRIM_KERNELS:
        if counts[k]["launches"] == 0:
            fail(f"primitives: {k} never launched")
    if any(c["plain_calls"] for c in counts.values()):
        fail(f"primitives: a plain version ran: {counts}")
    print(f"  generated builds after the path: {json.dumps(registry.GEN_BUILDS)}", flush=True)
    registry.reset_counts()
    # a late profiler session may drop its first ~18 launches (phase 12), a
    # whole path's: trace PATH_PROFILE_REPS paths and say how many were kept
    prof = profile_step(lambda: [case.run() for _ in range(PATH_PROFILE_REPS) for case in cases],
                        f"{PATH_PROFILE_REPS} primitives paths")
    launched = sum(c["launches"] for c in registry.counts().values())
    kept = sum(r["calls"] for r in prof["top"]
               if "ltt::" in r["kernel"] or "gemm_simt_kernel" in r["kernel"])
    print(f"  {kept} of the {launched} kernel launches of the port kept in the trace "
          f"(the idle share holds for what was kept)", flush=True)
    prof["kernels_recorded"] = [kept, launched]

    entries = check_and_time(spec, cases, outs, lambda case, got: prim_check(case, got,
                                                                             case.plain()))
    return {"primitives": counts}, entries, {"profile": prof,
                                             "generated_builds": dict(registry.GEN_BUILDS)}


# ---------------------------------------------------------------------------
# Phase 14: the layout and strided primitives (transpose2d out of place and
# in place, for_each over strided views, map_reduce_staged with mean_var /
# argmax / argmin) at bench.py's shapes
# ---------------------------------------------------------------------------

# mean and variance against the float64 oracle and the plain version
MEAN_VAR_REL = 1e-5
LAYOUT_KERNELS = ("transpose", "transpose_inplace", "for_each_strided_tiled",
                  "map_reduce_staged_one")
# the kernels the new routes replace (the two-launch staged template, the
# classic strided kernel): no launch on the path
LAYOUT_REPLACED = ("map_reduce_staged", "for_each_strided")


@dataclasses.dataclass
class Layout:
    name: str          # the kernel record
    slot: str          # "" for the record's main case
    shape: str
    run: Callable      # the kernel path on fresh inputs (counted once)
    plain: Callable    # its plain version on the same inputs
    check: Callable    # (got, want) -> max abs error; fails the phase past its bound
    nbytes: float      # each input read once, each output written once
    flops: float = 0.0
    time_run: Optional[Callable] = None
    library: Optional[Callable] = None
    library_call: Optional[str] = None
    repeat: bool = False   # a reduction: two runs bit-identical
    dtype: torch.dtype = torch.float32  # the input type: the bound's peak rate
    counted: bool = True   # part of the path's counted run (else a yardstick beside it)
    host: bool = False     # also 20 calls in a CUDA graph and the host's us a call


def _bits_equal(tag):
    def check(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst = 0.0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{tag}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            differ = int((g.view(torch.uint8) != w.view(torch.uint8)).sum().item())
            worst = max(worst, (g.double() - w.double()).abs().max().item() if g.numel() else 0.0)
            print(f"  {tag}: {differ} differing bytes of {g.numel() * g.element_size()} "
                  f"(bound 0)", flush=True)
            if differ:
                fail(f"{tag}: kernel and plain version differ in {differ} bytes")
        return worst
    return check


def _mean_var_check(x):
    x64 = x.double()
    m64, v64 = x64.mean().item(), x64.var(unbiased=False).item()

    def check(got, want):
        worst = 0.0
        for tag, g, w, o in (("mean", got[0], want[0], m64), ("var", got[1], want[1], v64)):
            rel_o = abs(g.item() - o) / abs(o)
            rel_p = abs(g.item() - w.item()) / abs(w.item())
            print(f"  map_reduce_staged mean_var {tag}: {g.item():.9g}, rel {rel_o:.3e} of "
                  f"float64, {rel_p:.3e} of plain (bound {MEAN_VAR_REL:.0e})", flush=True)
            if not (rel_o <= MEAN_VAR_REL and rel_p <= MEAN_VAR_REL):
                fail(f"mean_var {tag}: {g.item()} vs float64 {o}, plain {w.item()}")
            worst = max(worst, abs(g.item() - o))
        return worst
    return check


def _arg_check(x, fn):
    """index and value equal numpy's on the same data (first occurrence)"""
    host = x.float().cpu().numpy().reshape(-1) if x.dtype == torch.bfloat16 else \
        x.cpu().numpy().reshape(-1)
    i_np = int(getattr(np, fn)(host))

    def check(got, want):
        i, v = got
        print(f"  map_reduce_staged {fn} [{tuple(x.shape)}]: index {i.item()} (numpy {i_np}, "
              f"plain {want[0].item()}), value {v.item()} (numpy {host[i_np].item()})",
              flush=True)
        if not (i.item() == i_np == want[0].item() and v.item() == host[i_np].item()
                == want[1].item()):
            fail(f"{fn}: kernel ({i.item()}, {v.item()}) vs numpy ({i_np}, {host[i_np]})")
        return 0.0
    return check


def _custom_block(ctx, b):
    """count of positives and sum of negatives (tests/test_foreach.py:173-195),
    the count in int64, torch's count dtype: laser_tpu's f32 count is not
    exact past 2^24 elements, and 8192^2 has 2^26"""
    pos = (b > 0) & ctx.valid
    neg = (b < 0) & ctx.valid
    return {"npos": pos.sum(), "sneg": torch.where(neg, b, 0.0).sum()}


def _custom_combine(a, b):
    return {"npos": a["npos"] + b["npos"], "sneg": a["sneg"] + b["sneg"]}


def _custom_check(x):
    npos = int((x > 0).sum().item())
    sabs = x.double().abs().sum().item()

    def check(got, want):
        d = abs(got["sneg"].item() - want["sneg"].item())
        print(f"  map_reduce_staged custom: npos {got['npos'].item()} (exact {npos}), "
              f"sneg |d| {d:.3e} of sum |x| {sabs:.3e} (bound 1e-6)", flush=True)
        if got["npos"].item() != npos or got["npos"].item() != want["npos"].item() \
                or not d <= 1e-6 * sabs:
            fail(f"custom staged body: {got} vs {want}, npos {npos}")
        return d
    return check


def layout_sources():
    """The generated sources of phase 14's bodies, to build them together."""
    from laser_tpu_torch.ops import foreach as fe
    from laser_tpu_torch.ops import reductions as R
    from laser_tpu_torch.ops import strided as S

    f32 = torch.empty((8,), device=DEVICE)
    srcs = [S.strided_for_each_source(lambda p: p * 2.0, [torch.float32], torch.float32),
            fe.map_reduce_staged_source(R._mean_var_block, f32, combine=R._mean_var_combine,
                                        finish=R._mean_var_finish),
            fe.map_reduce_staged_source(_custom_block, f32, combine=_custom_combine)]
    for take_max in (True, False):
        block, comb = R.arg_reduce_fns(torch.float32, take_max)
        srcs.append(fe.map_reduce_staged_source(block, f32, combine=comb))
    return srcs


def layout_cases():
    from laser_tpu_torch.ops import foreach as fe
    from laser_tpu_torch.ops import reductions as R
    from laser_tpu_torch.ops import strided as S
    from laser_tpu_torch.ops import transpose as T
    from laser_tpu_torch.tensor import TensorView

    g = torch.Generator(device=DEVICE)
    g.manual_seed(14)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=DEVICE).to(dtype)

    cases = []
    # bench.py:339-385: every second row of 16384 x 4096 f32, o = 2x; then
    # the strided views of 1024 x 1000. On the tiled kernel (the path, through
    # for_each), then on the classic kernel asked for (outside the count)
    Mb, Cb = 16384, 4096
    xs = rnd(Mb, Cb)
    view = TensorView(xs.reshape(-1), (Mb // 2, Cb), (2 * Cb, 1), Cb)
    two = lambda p: p * 2.0  # noqa: E731
    n_half = Mb // 2 * Cb
    small = rnd(1024, 1000)
    flat = small.reshape(-1)
    views = [("", view), ("torch_every2row", xs[1::2]), ("strided_1d", flat[5::7]),
             ("negative_stride", TensorView(flat, (1024, 1000), (-1000, 1), 1023 * 1000)),
             ("transposed", small.t())]
    for name, route in (("for_each_strided_tiled", None), ("for_each_strided", "classic")):
        asked = ", the classic kernel asked for" if route else ""
        for slot, v in views:
            big = slot in ("", "torch_every2row")
            n = n_half if big else (v.size if isinstance(v, TensorView) else v.numel())
            run = (lambda v=v: fe.for_each(two, v)) if route is None else \
                (lambda v=v: S.strided_for_each(two, [v], route="classic"))
            cases.append(Layout(
                name, slot, (f"{Mb}x{Cb} every 2nd row, o = 2x"
                             + (" (TensorView, offset 4096)" if not slot else " (x[1::2])")
                             if big else f"{slot} view of 1024x1000") + asked,
                run=run, plain=lambda v=v: S.strided_for_each_reference(two, [v]),
                check=_bits_equal(f"{name} {slot or 'main'}"), nbytes=2 * n * 4, flops=n,
                library=(lambda: xs[1::2] * 2.0) if big else None,
                library_call="x[1::2] * 2.0" if big else None, counted=not route, host=True))
    # bench.py:398-413: 8192^2 f32 out of place and in place
    N = 8192
    xt = rnd(N, N)
    nb = N * N * 4
    cases.append(Layout(
        "transpose", "", f"{N}x{N} f32 out of place", run=lambda: T.transpose2d(xt),
        plain=lambda: T.transpose2d_reference(xt), check=_bits_equal("transpose main"),
        nbytes=2 * nb, library=lambda: xt.t().contiguous(),
        library_call="x.t().contiguous()"))
    xtb = rnd(N, N, dtype=torch.bfloat16)
    cases.append(Layout(
        "transpose", "bf16", f"{N}x{N} bf16 out of place", run=lambda: T.transpose2d(xtb),
        plain=lambda: T.transpose2d_reference(xtb), check=_bits_equal("transpose bf16"),
        nbytes=2 * N * N * 2, library=lambda: xtb.t().contiguous(),
        library_call="x.t().contiguous()", dtype=torch.bfloat16))
    # C1's conv-3 activation (phase 12), 16 x 64 x 56 x 56 f32
    act = rnd(16, 64, 56, 56)
    act_hwc = act.permute(0, 2, 3, 1).contiguous()
    cases.append(Layout(
        "transpose", "nchw2nhwc", "16x64x56x56 f32", run=lambda: T.nchw2nhwc(act),
        plain=lambda: T.transpose2d_batched_reference(act.flatten(2)).reshape(act_hwc.shape),
        check=_bits_equal("transpose nchw2nhwc"),
        nbytes=2 * act.numel() * 4, library=lambda: act.permute(0, 2, 3, 1).contiguous(),
        library_call="x.permute(0, 2, 3, 1).contiguous()"))
    cases.append(Layout(
        "transpose", "nhwc2nchw", "16x56x56x64 f32", run=lambda: T.nhwc2nchw(act_hwc),
        plain=lambda: T.transpose2d_batched_reference(act_hwc.flatten(1, 2)).reshape(act.shape),
        check=_bits_equal("transpose nhwc2nchw"),
        nbytes=2 * act.numel() * 4, library=lambda: act_hwc.permute(0, 3, 1, 2).contiguous(),
        library_call="x.permute(0, 3, 1, 2).contiguous()"))
    for shape in ((1, 1), (100, 37)):
        xo = rnd(*shape)
        cases.append(Layout(
            "transpose", "x".join(map(str, shape)), f"{shape[0]}x{shape[1]} f32",
            run=lambda xo=xo: T.transpose2d(xo), plain=lambda xo=xo: T.transpose2d_reference(xo),
            check=_bits_equal(f"transpose {shape}"), nbytes=2 * xo.numel() * 4))
    for n_ in (N, 128, 384):
        xi = rnd(n_, n_)
        tbuf = xi.clone()
        main = n_ == N
        cases.append(Layout(
            "transpose_inplace", "" if main else f"n{n_}", f"{n_}x{n_} f32 in place (donate)",
            run=lambda xi=xi: T.transpose2d(xi.clone(), donate=True),
            plain=lambda xi=xi: T.transpose_inplace_reference(xi.clone()),
            time_run=lambda tbuf=tbuf: T.transpose2d(tbuf, donate=True),
            check=_bits_equal(f"transpose_inplace {n_}"), nbytes=2 * n_ * n_ * 4,
            library=(lambda xi=xi: xi.t().contiguous()) if main else None,
            library_call="x.t().contiguous() (torch has no in-place transpose)" if main
            else None))
    # mean_var / argmax / argmin of 8192^2 f32, one read each: on the one
    # launch (map_reduce_staged_one), then on the two-launch template asked
    # for (map_reduce_staged, route="classic"), outside the path's count
    xr = rnd(N, N) * 3.0 + 1.0
    n_r = N * N

    def mean_var_plain():
        acc = fe.map_reduce_staged_reference(R._mean_var_block, xr, combine=R._mean_var_combine,
                                             finish=R._mean_var_finish)
        return acc["mean"], acc["var"]

    def arg_plain(x, fn):
        block, comb = R.arg_reduce_fns(x.dtype, fn == "argmax")
        acc = fe.map_reduce_staged_reference(block, x, combine=comb)
        return acc["idx"], acc["val"]

    for name, route in (("map_reduce_staged_one", None), ("map_reduce_staged", "classic")):
        asked = ", the two-launch template asked for" if route else ""
        cases.append(Layout(
            name, "", f"{N}x{N} f32 mean_var{asked}", run=lambda r=route: R.mean_var(xr, route=r),
            plain=mean_var_plain, check=_mean_var_check(xr), nbytes=n_r * 4, flops=8 * n_r,
            repeat=True, library=lambda: torch.var_mean(xr, correction=0),
            library_call="torch.var_mean(x, correction=0)", counted=not route, host=True))
        for fn in ("argmax", "argmin"):
            cases.append(Layout(
                name, fn, f"{N}x{N} f32 {fn}{asked}",
                run=lambda fn=fn, r=route: getattr(R, fn)(xr, route=r),
                plain=lambda fn=fn: arg_plain(xr, fn), check=_arg_check(xr, fn), nbytes=n_r * 4,
                flops=4 * n_r, repeat=True,
                library=(lambda: torch.max(xr.flatten(), 0)) if fn == "argmax"
                else (lambda: torch.min(xr.flatten(), 0)),
                library_call=f"torch.{fn[3:]}(x.flatten(), 0)", counted=not route, host=True))
    xc = xr - 1.0
    cases.append(Layout(
        "map_reduce_staged_one", "custom", f"{N}x{N} f32 count of positives, sum of negatives",
        run=lambda: fe.map_reduce_staged(_custom_block, xc, combine=_custom_combine),
        plain=lambda: fe.map_reduce_staged_reference(_custom_block, xc, combine=_custom_combine),
        check=_custom_check(xc), nbytes=n_r * 4, flops=6 * n_r, repeat=True))
    tie = torch.zeros(300001, device=DEVICE)
    tie[123457] = tie[200000] = 5.0
    cases.append(Layout(
        "map_reduce_staged_one", "argmax_tie", "300001 f32, the maximum twice",
        run=lambda: R.argmax(tie), plain=lambda: arg_plain(tie, "argmax"),
        check=_arg_check(tie, "argmax"), nbytes=tie.numel() * 4, repeat=True))
    return cases


def phase_layout(spec):
    from laser_tpu_torch import registry

    print("phase 14: layout and strided primitives at bench.py's shapes (transpose2d out of "
          "place and in place, for_each over strided views, map_reduce_staged: mean_var, "
          "argmax, argmin, a custom pytree body)", flush=True)
    t0 = time.perf_counter()
    built = dict(registry.GEN_BUILDS)
    srcs = layout_sources()
    registry.load_generated_many(srcs)
    print(f"  generated bodies: {len(set(srcs))} sources, "
          f"{registry.GEN_BUILDS['built'] - built['built']} built in parallel, "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    cases = layout_cases()
    path = [case for case in cases if case.counted]
    torch.cuda.synchronize()
    registry.reset_counts()
    outs = {id(case): case.run() for case in path}
    torch.cuda.synchronize()
    counts = registry.counts()
    outs.update({id(case): case.run() for case in cases if not case.counted})
    outs = [outs[id(case)] for case in cases]
    print(f"  counts {json.dumps({k: v for k, v in counts.items() if any(v.values())})}",
          flush=True)
    for k in LAYOUT_KERNELS:
        if counts[k]["launches"] == 0:
            fail(f"layout: {k} never launched")
    for k in LAYOUT_REPLACED:
        if counts[k]["launches"]:
            fail(f"layout: the replaced kernel {k} launched on the path")
    if any(c["plain_calls"] for c in counts.values()):
        fail(f"layout: a plain version ran: {counts}")
    registry.reset_counts()
    prof = profile_step(lambda: [case.run() for _ in range(PATH_PROFILE_REPS) for case in path],
                        f"{PATH_PROFILE_REPS} layout paths")
    launched = sum(c["launches"] for c in registry.counts().values())
    # every counted launch is one kernel, a staged reduction's too
    kept = sum(r["calls"] for r in prof["top"]
               if "ltt::" in r["kernel"] or "transpose" in r["kernel"])
    print(f"  {kept} of the {launched} kernel launches of the port kept in the trace "
          f"(the idle share holds for what was kept)", flush=True)
    prof["kernels_recorded"] = [kept, launched]

    entries = check_and_time(spec, cases, outs, lambda case, got: case.check(got, case.plain()))
    # the staged reductions and the strided views on both routes beside their
    # torch calls: 20 in a CUDA graph (the device's time without the host; a
    # 16384 x 4096 strided call moves 268 MB, past L2) and the host's us a call
    for case in cases:
        if not case.host:
            continue
        e = entries[case.name][case.slot] if case.slot else entries[case.name]
        lib = case.library
        e["graph_ms"], e["library_graph_ms"] = (cuda_graph_ms(case.run),
                                                cuda_graph_ms(lib) if lib else None)
        e["host_us"], e["library_host_us"] = host_us(case.run), host_us(lib) if lib else None
        print(f"  {case.name} {case.shape}: graph {e['graph_ms']:.4f} ms, host "
              f"{e['host_us']:.1f} us a call" + (
                  f"; {case.library_call}: graph {e['library_graph_ms']:.4f} ms, host "
                  f"{e['library_host_us']:.1f} us" if lib else ""), flush=True)
    return {"layout": counts}, entries, {"profile": prof}

# ---------------------------------------------------------------------------
# Phase 15: the GEMM dtype table at bench.py's shapes (int8 -> int32, exact
# int32 / int64 / f64, the batched GEMM, int8 quantization)
# ---------------------------------------------------------------------------

TABLE_KERNELS = ("gemm_i8_wgmma", "gemm_batched_wgmma", "gemm_int32_wgmma", "gemm_limbs_wgmma",
                 "quantize_int8", "transpose")
# the WMMA kernels the int8 wgmma routes replace: no launch on the path
TABLE_REPLACED = ("gemm", "gemm_int32", "gemm_limbs")
# f64 through digit slices, relative to K * rowmax|a| * colmax|b|: against
# the plain route (the same digits and bucket sums) and against cuBLAS
# DGEMM (8 slices: the classical f64 bound; 4 slices: the fast tier)
F64_PLAIN_REL = 1e-15
F64_DGEMM_REL = {8: 2.0 ** -50, 4: 2.0 ** -24}
# bf16 batched outputs: one bf16 rounding of max |plain|
BATCHED_BF16_REL = 2.0 ** -7
ORACLE_CORNER = 64


@dataclasses.dataclass
class Table:
    name: str          # the kernel record
    slot: str          # "" for the record's main case
    shape: str
    run: Callable      # the path through the kernel (counted once)
    plain: Callable    # its plain version on the same inputs
    check: Callable    # (got, want) -> max abs error; fails the phase past its bound
    nbytes: float      # each input read once, each output written once
    flops: float
    peak: float        # the rate of the work's type, TOP/s or TFLOP/s
    time_run: Optional[Callable] = None   # the kernel alone (pre-split digits)
    library: Optional[Callable] = None
    library_call: Optional[str] = None
    repeat: bool = False
    dtype: torch.dtype = torch.float32
    counted: bool = True  # part of the path's counted run (else a yardstick beside it)


def _wrap_np(w, bits):
    """object or int64 numpy integers -> their value mod 2^bits as signed."""
    u = np.vectorize(lambda v: int(v) % 2**bits, otypes=[object])(w)
    return u.astype(np.uint64).astype(np.uint64 if bits == 64 else np.uint32).view(
        np.int64 if bits == 64 else np.int32)


def _int_check(tag, oracle, library=None):
    """Bits equal to the plain version; the plain version's 64 x 64 corner
    equal to an exact host oracle; the library call's bits, if any."""
    bits = _bits_equal(tag)

    def check(got, want):
        err = bits(got, want)
        corner = want[:ORACLE_CORNER, :ORACLE_CORNER].cpu().numpy()
        ok = np.array_equal(corner, oracle())
        print(f"  {tag}: plain's {corner.shape[0]}x{corner.shape[1]} corner equals the exact "
              f"integer oracle: {ok}", flush=True)
        if not ok:
            fail(f"{tag}: the plain version differs from the exact oracle")
        if library is not None:
            same = torch.equal(got, library())
            print(f"  {tag}: bit-identical to the library call: {same}", flush=True)
            if not same:
                fail(f"{tag}: kernel and library call differ")
        return err
    return check


def _f64_check(tag, a, b, slices):
    K = a.shape[1]
    scale = K * a.abs().amax(1)[:, None] * b.abs().amax(0)[None, :]

    def check(got, want):
        torch.cuda.synchronize()
        rel_p = ((got - want).abs() / scale).max().item()
        dgemm = torch.matmul(a, b)
        rel_d = ((got - dgemm).abs() / scale).max().item()
        print(f"  {tag}: {rel_p:.3e} of K rowmax colmax from plain (bound {F64_PLAIN_REL:.0e}), "
              f"{rel_d:.3e} from cuBLAS DGEMM (bound {F64_DGEMM_REL[slices]:.1e})", flush=True)
        if not (rel_p <= F64_PLAIN_REL and rel_d <= F64_DGEMM_REL[slices]):
            fail(f"{tag}: f64 error {rel_p:.3e} / {rel_d:.3e} past its bound")
        return (got - want).abs().max().item()
    return check


def _rel_check(tag, bound_):
    def check(got, want):
        torch.cuda.synchronize()
        err, rel = rel_error(got, want)
        print(f"  {tag}: max_abs_err {err:.3e} rel {rel:.3e} (bound {bound_:.1e})", flush=True)
        if not rel <= bound_:
            fail(f"{tag}: relative error {rel:.3e} > {bound_:.1e}")
        return err
    return check


def _quant_check(tag):
    bits = _bits_equal(tag)

    def check(got, want):
        return max(bits(got[0], want[0]), bits(got[1], want[1]))
    return check


def table_cases(spec, n: int = 4096, m: int = 2048):
    """bench.py's GEMM dtype rows (bench.py:128-273: int8 at n^3, the
    others at m^3) and BASELINE.json's batched GEMM (n^3), data as bench.py
    makes it, from a seed. Returns the cases and the runs to profile
    ({what: fn}: the int64 and f64 GEMMs end to end)."""
    from laser_tpu_torch.ops import quant as Q
    from laser_tpu_torch.ops import transpose as TR
    from laser_tpu_torch.ops.gemm import batched as BT
    from laser_tpu_torch.ops.gemm import f64_kernel as F64
    from laser_tpu_torch.ops.gemm import int32_kernel as I32
    from laser_tpu_torch.ops.gemm import int64_kernel as I64
    from laser_tpu_torch.ops.gemm import kernel as KR
    from laser_tpu_torch.ops.gemm import limb_kernel as L
    from laser_tpu_torch.ops.gemm.api import gemm

    g = torch.Generator(device=DEVICE)
    g.manual_seed(15)
    C = ORACLE_CORNER
    cases = []

    # int8 4096^3, randint(-8, 8) (bench.py:128-176, :1130): the wgmma route
    # with B copied K-major first (a transpose launch on the path); beside
    # it, outside the path's count, the WMMA kernel it replaces (B read in
    # place), the product on a K-major B (no copy) against _int_mm in
    # cuBLASLt's native TN layout, and the copy alone
    a8 = torch.randint(-8, 8, (n, n), generator=g, device=DEVICE, dtype=torch.int8)
    b8 = torch.randint(-8, 8, (n, n), generator=g, device=DEVICE, dtype=torch.int8)
    b8t = b8.t().contiguous()
    int8 = dict(plain=lambda: KR.gemm_plain(a8, b8),
                check=_int_check("gemm int8", lambda: a8[:C].cpu().numpy().astype(np.int64)
                                 @ b8[:, :C].cpu().numpy().astype(np.int64),
                                 library=lambda: torch._int_mm(a8, b8)),
                nbytes=2 * n * n + 4 * n * n, flops=2 * n ** 3, peak=spec.int8_tops,
                dtype=torch.int8)
    cases.append(Table(
        "gemm_i8_wgmma", "", f"{n}^3 int8 -> int32, randint(-8, 8), B row-major (copied "
        "K-major first: a transpose launch)", run=lambda: gemm(a8, b8),
        library=lambda: torch._int_mm(a8, b8),
        library_call="torch._int_mm (cuBLASLt int8), B row-major", **int8))
    cases.append(Table(
        "gemm", "int8", f"{n}^3 int8 -> int32, the WMMA kernel asked for",
        run=lambda: KR.gemm_fused(a8, b8, route="classic"),
        library=lambda: torch._int_mm(a8, b8),
        library_call="torch._int_mm (cuBLASLt int8), B row-major", counted=False, **int8))
    cases.append(Table(
        "gemm_i8_wgmma", "b_kmajor", f"{n}^3 int8 -> int32, B given K-major (transpose_b, "
        "no copy)", run=lambda: KR.gemm_fused(a8, b8t, transpose_b=True),
        library=lambda: torch._int_mm(a8, b8t.t()),
        library_call="torch._int_mm (cuBLASLt int8), B column-major (TN, its native layout)",
        counted=False, **int8))
    cases.append(Table(
        "transpose", "int8_b_copy", f"{n}x{n} int8 -> K-major: the int8 route's copy of B",
        run=lambda: TR.transpose2d(b8), plain=lambda: TR.transpose2d_reference(b8),
        check=_bits_equal("int8 B copy"), nbytes=2 * n * n, flops=0, peak=spec.int8_tops,
        library=lambda: b8.t().contiguous(), library_call="b.t().contiguous()",
        counted=False, dtype=torch.int8))

    # int32 2048^3, randint(-1000, 1000) (bench.py:178-204): 10 limb
    # products; the kernel alone on pre-split limbs (B's K-major, as
    # gemm_int32 splits b.t()), and the WMMA kernel it replaces on the same
    # limbs
    a32 = torch.randint(-1000, 1000, (m, m), generator=g, device=DEVICE, dtype=torch.int32)
    b32 = torch.randint(-1000, 1000, (m, m), generator=g, device=DEVICE, dtype=torch.int32)
    la, lb, lbt = I32.int32_limbs(a32), I32.int32_limbs(b32), I32.int32_limbs(b32.t())
    int32 = dict(plain=lambda: I32.gemm_int32_limbs_plain(la, lb),
                 check=_int_check("gemm_int32", lambda: _wrap_np(
                     a32[:C].cpu().numpy().astype(np.int64)
                     @ b32[:, :C].cpu().numpy().astype(np.int64), 32)),
                 nbytes=3 * 4 * m * m, flops=10 * 2 * m ** 3, peak=spec.int8_tops,
                 dtype=torch.int32)
    cases.append(Table(
        "gemm_int32_wgmma", "", f"{m}^3 int32, randint(-1000, 1000), exact mod 2^32",
        run=lambda: gemm(a32, b32), time_run=lambda: I32.gemm_int32_limbs_kmajor(la, lbt),
        **int32))
    cases.append(Table(
        "gemm_int32", "", f"{m}^3 int32 on pre-split limbs (B's K-major), the WMMA kernel "
        "asked for", run=lambda: I32.gemm_int32_limbs_kmajor(la, lbt, route="classic"),
        counted=False, **int32))

    # int64 2048^3, full range (bench.py:258-273): 36 limb products; the
    # limb kernel alone on the pre-split digits is bench.py's device rate
    a64 = torch.randint(-2**63, 2**63 - 1, (m, m), generator=g, device=DEVICE,
                        dtype=torch.int64)
    b64 = torch.randint(-2**63, 2**63 - 1, (m, m), generator=g, device=DEVICE,
                        dtype=torch.int64)
    da, db = I64.int64_limbs(a64), I64.int64_limbs(b64)
    dbt = I64.int64_limbs(b64.t())

    def oracle64():
        w = a64[:C].cpu().numpy().astype(object) @ b64[:, :C].cpu().numpy().astype(object)
        return _wrap_np(w, 64)

    limbs = dict(plain=lambda: L.gemm_limbs_plain(da, db, 8),
                 check=_bits_equal("gemm_limbs int64 digits"),
                 nbytes=2 * 8 * m * m + 8 * 4 * m * m, flops=36 * 2 * m ** 3,
                 peak=spec.int8_tops, dtype=torch.int8)
    cases.append(Table(
        "gemm_limbs_wgmma", "", f"{m}^3, 8 x 8 int8 digit planes of int64 -> 8 buckets "
        "(B's K-major)", run=lambda: L.gemm_limbs_kmajor(da, dbt, 8), **limbs))
    cases.append(Table(
        "gemm_limbs", "", f"{m}^3, 8 x 8 int64 digit planes -> 8 buckets (B's K-major), the "
        "WMMA kernel asked for", run=lambda: L.gemm_limbs_kmajor(da, dbt, 8, route="classic"),
        counted=False, **limbs))
    cases.append(Table(
        "gemm_limbs_wgmma", "public", f"gemm_limbs {m}^3 on (8, K, N) planes: one K-major "
        "copy, then the kernel", run=lambda: L.gemm_limbs(da, db, 8), counted=False, **limbs))
    cases.append(Table(
        "transpose", "limb_b_copy", f"8 x {m}x{m} int8 planes -> K-major: gemm_limbs' copy",
        run=lambda: TR.transpose2d_batched(db), plain=lambda: TR.transpose2d_batched_reference(db),
        check=_bits_equal("limb B copy"), nbytes=2 * 8 * m * m, flops=0, peak=spec.int8_tops,
        counted=False, dtype=torch.int8))
    cases.append(Table(
        "gemm_limbs_wgmma", "int64_gemm", f"gemm {m}^3 int64, full range, exact mod 2^64 "
        "(digit split, limb kernel, combine)", run=lambda: gemm(a64, b64),
        plain=lambda: I64.gemm_int64(a64, b64, limbs=L.gemm_limbs_kmajor_plain),
        check=_int_check("gemm int64", oracle64), nbytes=3 * 8 * m * m,
        flops=36 * 2 * m ** 3, peak=spec.int8_tops, dtype=torch.int64))

    # f64 2048^3, randn * 2^[-30, 30) (bench.py:207-256): 8 and 4 slices;
    # the least time for an f64 product is cuBLAS DGEMM's rate
    af = torch.randn(m, m, generator=g, device=DEVICE, dtype=torch.float64) * torch.exp2(
        torch.randint(-30, 30, (m, m), generator=g, device=DEVICE).double())
    bf = torch.randn(m, m, generator=g, device=DEVICE, dtype=torch.float64) * torch.exp2(
        torch.randint(-30, 30, (m, m), generator=g, device=DEVICE).double())
    fa, _ = F64.f64_digits(af, 1, 8)
    fb, _ = F64.f64_digits(bf, 0, 8)
    fbt, _ = F64.f64_digits(bf.t(), 1, 8)
    for slices, tag in ((8, "accurate"), (4, "fast")):
        cases.append(Table(
            "gemm_limbs_wgmma", f"f64_{tag}",
            f"gemm_f64 {m}^3, randn * 2^[-30, 30), {slices} slices",
            run=(lambda s=slices: F64.gemm_f64(af, bf, slices=s)),
            plain=(lambda s=slices: F64.gemm_f64(af, bf, slices=s,
                                                 limbs=L.gemm_limbs_kmajor_plain)),
            check=_f64_check(f"gemm_f64 {tag}", af, bf, slices), nbytes=3 * 8 * m * m,
            flops=2 * m ** 3, peak=spec.f64_tflops,
            library=lambda: torch.matmul(af, bf), library_call="torch.matmul f64 (cuBLAS DGEMM)",
            dtype=torch.float64))
    digits64 = dict(plain=lambda: L.gemm_limbs_plain(fa, fb, 8),
                    check=_bits_equal("gemm_limbs f64 digits"),
                    nbytes=2 * 8 * m * m + 8 * 4 * m * m, flops=2 * m ** 3,
                    peak=spec.f64_tflops, library=lambda: torch.matmul(af, bf),
                    library_call="torch.matmul f64 (cuBLAS DGEMM)", dtype=torch.int8)
    cases.append(Table(
        "gemm_limbs_wgmma", "f64_digits", f"{m}^3, 8 x 8 f64 digit planes -> 8 buckets "
        "(B's K-major)", run=lambda: L.gemm_limbs_kmajor(fa, fbt, 8), **digits64))
    cases.append(Table(
        "gemm_limbs", "f64_digits", f"{m}^3, 8 x 8 f64 digit planes -> 8 buckets (B's "
        "K-major), the WMMA kernel asked for",
        run=lambda: L.gemm_limbs_kmajor(fa, fbt, 8, route="classic"), counted=False,
        **digits64))

    # BASELINE.json:11's bf16 4096^3 batched GEMM, 4 entries
    B = 4
    ab = torch.randn(B, n, n, generator=g, device=DEVICE).bfloat16()
    bb = (torch.randn(B, n, n, generator=g, device=DEVICE) * n ** -0.5).bfloat16()
    batched = dict(plain=lambda: BT.gemm_batched_plain(ab, bb, torch.bfloat16),
                   check=_rel_check("gemm_batched bf16", BATCHED_BF16_REL),
                   nbytes=3 * B * n * n * 2, flops=2 * B * n ** 3, peak=spec.bf16_tflops,
                   library=lambda: torch.bmm(ab, bb), library_call="torch.bmm (cuBLAS)",
                   dtype=torch.bfloat16)
    cases.append(Table("gemm_batched_wgmma", "", f"B{B} {n}^3 bf16",
                       run=lambda: BT.gemm_batched(ab, bb), **batched))
    # the WMMA kernel the wgmma route replaces, outside the path's count
    cases.append(Table("gemm_batched", "", f"B{B} {n}^3 bf16, the WMMA kernel asked for",
                       run=lambda: BT._gemm_batched_cuda(ab, bb, torch.bfloat16,
                                                         route="classic"),
                       counted=False, **batched))

    # quantize_int8 of a 4096^2 f32 activation: per row, global, stochastic
    xq = torch.randn(n, n, generator=g, device=DEVICE) * 3.0
    qbytes = n * n * 4 + n * n
    for slot, kw in (("", dict()), ("global", dict(per_row=False)),
                     ("stochastic", dict(stochastic=True, seed=5))):
        cases.append(Table(
            "quantize_int8", slot, f"{n}x{n} f32 {slot or 'per row'}",
            run=(lambda kw=kw: Q.quantize_int8(xq, **kw)),
            plain=(lambda kw=kw: Q.quantize_int8_plain(xq, kw.get("per_row", True),
                                                        kw.get("stochastic", False),
                                                        kw.get("seed", 0))),
            check=_quant_check(f"quantize_int8 {slot or 'per row'}"),
            nbytes=qbytes + 4 * (n if not slot == "global" else 1), flops=3 * n * n,
            peak=spec.f32_tflops))

    # gemm_quantized of 4096^3 f32: two quantizations, the int8 GEMM, rescale
    aq = torch.randn(n, n, generator=g, device=DEVICE)
    bq = torch.randn(n, n, generator=g, device=DEVICE)

    def quantized_plain():
        qa, sa = Q.quantize_int8_plain(aq)
        qb, sb = Q.quantize_int8_plain(bq.t(), seed=1)
        return KR.gemm_plain(qa, qb, transpose_b=True).float() * sa * sb.reshape(1, -1)

    cases.append(Table(
        "gemm_i8_wgmma", "quantized", f"gemm_quantized {n}^3 f32 (int8 per row / per column)",
        run=lambda: Q.gemm_quantized(aq, bq), plain=quantized_plain,
        check=_bits_equal("gemm_quantized"), nbytes=3 * 4 * n * n, flops=2 * n ** 3,
        peak=spec.int8_tops))
    profiled = {f"gemm int64 {m}^3": lambda: gemm(a64, b64),
                f"gemm_f64 {m}^3, 8 slices": lambda: F64.gemm_f64(af, bf, slices=8)}
    return cases, profiled


def table_small_checks():
    """Each new kernel once at a small odd shape, bit for bit against its
    plain version (phase 2)."""
    from laser_tpu_torch.ops import quant as Q
    from laser_tpu_torch.ops.gemm import batched as BT
    from laser_tpu_torch.ops.gemm import int32_kernel as I32
    from laser_tpu_torch.ops.gemm import kernel as KR
    from laser_tpu_torch.ops.gemm import limb_kernel as L

    g = torch.Generator(device=DEVICE)
    g.manual_seed(2)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=DEVICE, dtype=torch.int8)

    def i32(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=DEVICE,
                             dtype=torch.int32)

    a, bt, c, bias = i8(37, 100), i8(45, 100), i32(37, 45), i32(45)
    kw = dict(alpha=3, beta=-2, c=c, bias=bias, epilogue="relu", transpose_b=True)
    aw, bw, cw, biasw = i8(130, 96), i8(96, 45), i32(130, 45), i32(45)
    kww = dict(alpha=-3, beta=2, c=cw, bias=biasw, epilogue="relu")
    lwa, lwb, lwc = I32.int32_limbs(i32(5, 112)), I32.int32_limbs(i32(112, 7)), i32(5, 7)
    dwa, dwb = i8(3, 33, 48), i8(5, 48, 65)
    la, lb, lc = I32.int32_limbs(i32(5, 100)), I32.int32_limbs(i32(100, 7)), i32(5, 7)
    da, db = i8(3, 33, 31), i8(5, 31, 65)
    ab, bb = i8(3, 17, 33), i8(3, 33, 9)
    xq = torch.randn(37, 100, generator=g, device=DEVICE)
    checks = (
        ("gemm int8 37x100x45, B^T, C, bias, relu", lambda: KR.gemm_fused(a, bt, **kw),
         lambda: KR.gemm_plain(a, bt, **kw)),
        ("gemm_batched int8 3x17x33x9", lambda: BT.gemm_batched(ab, bb),
         lambda: BT.gemm_batched_plain(ab, bb, torch.int32)),
        ("gemm_int32 5x100x7, alpha, beta, C",
         lambda: I32.gemm_int32_limbs(la, lb, -2**31, 2**31 - 1, lc),
         lambda: I32.gemm_int32_limbs_plain(la, lb, -2**31, 2**31 - 1, lc)),
        ("gemm_limbs 3 x 5 planes 33x31x65 -> 6 buckets", lambda: L.gemm_limbs(da, db, 6),
         lambda: L.gemm_limbs_plain(da, db, 6)),
        ("gemm int8 130x96x45 (wgmma route), C, bias, relu",
         lambda: KR.gemm_fused(aw, bw, route="wgmma", **kww), lambda: KR.gemm_plain(aw, bw, **kww)),
        ("gemm_int32 5x112x7 (wgmma route), alpha, beta, C",
         lambda: I32.gemm_int32_limbs(lwa, lwb, -2**31, 2**31 - 1, lwc, route="wgmma"),
         lambda: I32.gemm_int32_limbs_plain(lwa, lwb, -2**31, 2**31 - 1, lwc)),
        ("gemm_limbs 3 x 5 planes 33x48x65 -> 8 buckets (wgmma route)",
         lambda: L.gemm_limbs(dwa, dwb, 8, route="wgmma"), lambda: L.gemm_limbs_plain(dwa, dwb, 8)),
        ("quantize_int8 37x100 stochastic", lambda: Q.quantize_int8(xq, stochastic=True, seed=3),
         lambda: Q.quantize_int8_plain(xq, True, True, 3)))
    for tag, kern, plain in checks:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not _same_bits(got, want):
            fail(f"{tag}: kernel and plain version differ")
        print(f"  {tag}: bit-identical to the plain version", flush=True)
    same_bits("gemm int8 130x96x45, C, bias, relu: the wgmma route and the WMMA kernel",
              lambda: KR.gemm_fused(aw, bw, route="wgmma", **kww),
              lambda: KR.gemm_fused(aw, bw, route="classic", **kww))


def library_small_checks():
    """Each library kernel once at a small odd shape against its plain
    version (phase 2): the packed GEMM at 100 x 120 x 90 on an odd plan
    (48 x 80 x 40, the gather route) with beta * C, int8 -> int32 and f16,
    bf16 on a planned plan (the wgmma route), f32 on one (the simt route,
    also bit for bit against the classic kernels) and int8 on one (the int8
    wgmma route, bit for bit against the classic kernel and plain); the
    stencil at 12 x 16, 2 x 5 (no interior: no launch) and bf16 33 x 65; the optimizers on a 37-element
    bias and a (3, 5, 7) leaf in f32 and bf16 (SGD on the multi-tensor
    kernel and on the per-leaf kernel asked for). Bit for bit, the floats of the
    packed GEMM within PACKED_REL (f16 as bf16)."""
    from laser_tpu_torch.ops import optim
    from laser_tpu_torch.ops import stencil as ST
    from laser_tpu_torch.ops.gemm import prepacked as PK

    g = torch.Generator(device=DEVICE)
    g.manual_seed(16)
    M, N, K = 100, 120, 90
    odd = PK.GemmTiles(48, 80, 40, 0)
    for dt in (torch.float32, torch.float16, torch.int8, torch.bfloat16):
        if dt == torch.int8:
            a = torch.randint(-128, 128, (M, K), generator=g, device=DEVICE, dtype=dt)
            b = torch.randint(-128, 128, (K, N), generator=g, device=DEVICE, dtype=dt)
            c = torch.randint(-2**31, 2**31 - 1, (M, N), generator=g, device=DEVICE,
                              dtype=torch.int32)
            alpha, beta, acc = 3, -2, torch.int32
        else:
            a = torch.randn(M, K, generator=g, device=DEVICE).to(dt)
            b = (torch.randn(K, N, generator=g, device=DEVICE) * K ** -0.5).to(dt)
            c = torch.randn(M, N, generator=g, device=DEVICE)
            alpha, beta, acc = 0.5, -1.5, torch.float32
        tiles = None if dt == torch.bfloat16 else odd
        pa, pb = PK.gemm_prepack_a(a, tiles=tiles), PK.gemm_prepack_b(b, tiles=tiles)
        got = PK.gemm_packed(alpha, pa, pb, beta, c)
        want = PK.gemm_packed_plain(alpha, pa, pb, beta, c, dt, acc, got.dtype)
        plan = (pa.block[0], pb.block[1], pa.block[1])
        route = "wgmma" if PK.wgmma_route(dt, *plan) else "simt" if PK.simt_route(dt, *plan) \
            else "blocks" if PK.blocks_route(dt, *plan) else "gather"
        tag = f"gemm_packed {M}x{N}x{K} {dt} tiles {pa.block[0]}x{pb.block[1]}x{pa.block[1]} " \
              f"({route} route), beta * C"
        if dt == torch.int8:
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{tag}: kernel and plain version differ")
            print(f"  {tag}: bit-identical to the plain version", flush=True)
        else:
            _rel_check(tag, PACKED_REL[torch.float32 if dt == torch.float32
                                       else torch.bfloat16])(got, want)
        if dt == torch.float32:  # and on a planned plan: the simt route
            pa, pb = PK.gemm_prepack_a(a), PK.gemm_prepack_b(b)
            got = PK.gemm_packed(alpha, pa, pb, beta, c)
            want = PK.gemm_packed_plain(alpha, pa, pb, beta, c, dt, acc, got.dtype)
            _rel_check(f"gemm_packed {M}x{N}x{K} f32 tiles {pa.block[0]}x{pb.block[1]}x"
                       f"{pa.block[1]} (simt route), beta * C", PACKED_REL[dt])(got, want)
            same_bits("gemm_packed f32 simt route against the classic kernels",
                      lambda: PK.gemm_packed(alpha, pa, pb, beta, c, route="simt"),
                      lambda: PK.gemm_packed(alpha, pa, pb, beta, c, route="classic"))
        if dt == torch.int8:  # and on a planned plan: the int8 wgmma route
            pa, pb = PK.gemm_prepack_a(a), PK.gemm_prepack_b(b)
            same_bits(f"gemm_packed {M}x{N}x{K} int8 tiles {pa.block[0]}x{pb.block[1]}x"
                      f"{pa.block[1]} (wgmma route), beta * C, against the classic kernel and "
                      "the plain version",
                      lambda: PK.gemm_packed(alpha, pa, pb, beta, c),
                      lambda: PK.gemm_packed(alpha, pa, pb, beta, c, route="classic"),
                      lambda: PK.gemm_packed_plain(alpha, pa, pb, beta, c, dt, acc, torch.int32))
    for shape, dt in (((12, 16), torch.float32), ((2, 5), torch.float32),
                      ((33, 65), torch.bfloat16)):
        u = torch.randn(shape, generator=g, device=DEVICE).to(dt)
        f = (torch.randn(shape, generator=g, device=DEVICE) * 0.5).to(dt)
        for method in ("redblack", "jacobi"):
            got = ST.stencil_solve(u, f, iters=3, method=method)
            torch.cuda.synchronize()
            if not _same_bits(got, ST.stencil_sweeps_plain(u, f, 3, method)):
                fail(f"stencil {shape} {dt} {method}: kernel and plain version differ")
        print(f"  stencil {shape[0]}x{shape[1]} {DTYPE_TAGS[dt]}, 3 red-black and 3 Jacobi "
              f"iterations: bit-identical to the plain version", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        tree = lambda: {"bias": torch.randn(37, generator=g, device=DEVICE).to(dt),  # noqa: E731
                        "w": torch.randn(3, 5, 7, generator=g, device=DEVICE).to(dt)}
        p, grads = tree(), tree()
        m, v = optim.adamw_init(p)
        mom = optim.tree_map(torch.zeros_like, p)
        lr = torch.tensor(1e-2, device=DEVICE)
        want_p, want_m, want_v = _clone_tree((p, m, v))
        for step, wd in ((1, 0.0), (2, 0.1)):
            optim.adamw_step(p, grads, m, v, step, lr=lr, weight_decay=wd, backend="pallas")
            _plain_adamw(want_p, grads, want_m, want_v, step, lr, wd)
        _tree_bits(f"adamw_update bias 37 + (3, 5, 7) {DTYPE_TAGS[dt]}, 2 steps", (p, m, v),
                   (want_p, want_m, want_v))
        want = _clone_tree((p, mom))
        classic = _clone_tree((p, mom))
        for nesterov in (False, True):
            optim.sgd_momentum_step(p, grads, mom, lr=lr, nesterov=nesterov, backend="pallas")
            _sgd_classic(classic[0], grads, classic[1], lr, nesterov)
            _plain_sgd(*want[:1], grads, want[1], lr, nesterov)
        _tree_bits(f"sgdm_multi bias 37 + (3, 5, 7) {DTYPE_TAGS[dt]}, plain and Nesterov",
                   (p, mom), want)
        _tree_bits(f"sgdm_update (per leaf, asked for) bias 37 + (3, 5, 7) {DTYPE_TAGS[dt]}, "
                   "plain and Nesterov", classic, want)


def phase_gemm_table(spec):
    from laser_tpu_torch import registry

    print("phase 15: GEMM dtype table at bench.py's shapes (int8 -> int32, int32, int64, f64, "
          "batched bf16, int8 quantization)", flush=True)
    for dt in (torch.int32, torch.int64):
        x = torch.ones(2, 2, dtype=dt, device=DEVICE)
        try:
            torch.matmul(x, x)
            print(f"  torch.matmul on CUDA {dt}: runs", flush=True)
        except RuntimeError as e:
            print(f"  torch.matmul on CUDA {dt}: {str(e).splitlines()[0]} (no library GEMM)",
                  flush=True)
    cases, profiled = table_cases(spec)
    torch.cuda.synchronize()
    registry.reset_counts()
    outs = {i: case.run() for i, case in enumerate(cases) if case.counted}
    torch.cuda.synchronize()
    counts = registry.counts()
    outs.update({i: case.run() for i, case in enumerate(cases) if not case.counted})
    outs = [outs[i] for i in range(len(cases))]
    print(f"  counts {json.dumps({k: v for k, v in counts.items() if any(v.values())})}",
          flush=True)
    for k in TABLE_KERNELS:
        if counts[k]["launches"] == 0:
            fail(f"gemm table: {k} never launched")
    for k in TABLE_REPLACED:
        if counts[k]["launches"]:
            fail(f"gemm table: the replaced kernel {k} launched on the path")
    if any(c["plain_calls"] for c in counts.values()):
        fail(f"gemm table: a plain version ran: {counts}")
    entries = check_and_time(spec, cases, outs, lambda case, got: case.check(got, case.plain()))
    # the limb kernel's share of the int64 and f64 GEMMs' device time; the
    # rest is the torch digit split and combine
    for what, fn in profiled.items():
        fn()
        prof = profile_step(lambda: [fn() for _ in range(3)], f"{what}, 3 calls")
        kern = sum(r["ms"] for r in prof["top"] if "limb_wgmma_kernel" in r["kernel"])
        print(f"  {what}: limb kernel {kern / 3:.4f} ms a call, "
              f"{100 * kern / prof['busy_ms']:.1f}% of device busy; the digit split and "
              f"combine {(prof['busy_ms'] - kern) / 3:.4f} ms a call", flush=True)
        entries["gemm_limbs_wgmma"].setdefault("profiles", {})[what] = {
            **prof, "limb_kernel_ms_per_call": kern / 3,
            "split_combine_ms_per_call": (prof["busy_ms"] - kern) / 3}
    return {"gemm_table": counts}, entries


# ---------------------------------------------------------------------------
# Phase 16: the library surface (the fused AdamW and SGD-momentum updates,
# the stencil solver, the prepacked GEMM) at full size
# ---------------------------------------------------------------------------

LIBRARY_KERNELS = ("adamw_update", "sgdm_multi", "stencil_sweep", "gemm_packed_simt",
                   "gemm_packed_wgmma", "gemm_packed_i8_wgmma")
# the classic packed kernels the wgmma and simt routes replace: no launch on the path
LIBRARY_REPLACED = ("gemm_packed",)
# packed GEMM, kernel vs plain and vs torch.matmul on the unpacked operands
# (TF32 off), max |d| / max |want|: bf16 one output rounding, f32 summation
# order over K = 4096
PACKED_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
STENCIL_N, STENCIL_ITERS = 1024, 100
# SGD steps under the profiler (one launch a step)
SGD_PROFILE_STEPS = 50
PACKED_N, PACKED_A_COUNT, PACKED_ALPHA = 4096, 4, 0.05
# the packed int8 product (the int8 wgmma route; the classic kernel beside
# it): randint(-8, 8) operands, alpha 1, exact in int32
# f32 operations a stencil cell update takes: 4 adds or subtracts, 1 multiply
STENCIL_FLOPS = 6
# AdamW and SGD operations an element: counted in csrc/optim.cu's adam_elem
# (with the decay) and sgd_elem (Nesterov)
ADAMW_FLOPS, SGD_FLOPS = 16, 5


def _clone_tree(tree):
    from laser_tpu_torch.ops.optim import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _tree_bits(tag, got, want):
    """Every leaf of two trees the same bits; returns max |d|."""
    from laser_tpu_torch.ops.optim import tree_leaves

    torch.cuda.synchronize()
    differ, worst = 0, 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{tag}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        differ += int((g.view(torch.uint8) != w.view(torch.uint8)).sum().item())
        worst = max(worst, (g.double() - w.double()).abs().max().item())
        if not torch.isfinite(g.float()).all():
            fail(f"{tag}: non-finite values")
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(got))
    print(f"  {tag}: {differ} differing bytes of {nbytes} (bound 0)", flush=True)
    if differ:
        fail(f"{tag}: kernel and plain version differ in {differ} bytes")
    return worst


def _plain_adamw(params, grads, m, v, step, lr, wd):
    """adamw_step(backend="pallas")'s arithmetic through the plain versions,
    leaf by leaf, in place."""
    from laser_tpu_torch.ops import optim

    bc1, bc2 = optim._bias_corrections(step, 0.9, 0.999)
    for p, g, mm, vv in zip(*(optim.tree_leaves(t) for t in (params, grads, m, v)), strict=True):
        optim.adamw_update_plain(p, g, mm, vv, lr=lr, b1=0.9, b2=0.999, omb1=float(1.0 - 0.9),
                                 omb2=float(1.0 - 0.999), eps=1e-8, wd=wd, bc1=bc1, bc2=bc2,
                                 has_wd=not (isinstance(wd, float) and wd == 0.0))
    return params, m, v


def _sgd_classic(params, grads, mom, lr, nesterov):
    """sgd_momentum_step(backend="pallas") on the per-leaf kernel asked for."""
    from laser_tpu_torch.ops import optim

    return optim.sgd_momentum_step(params, grads, mom, lr=lr, nesterov=nesterov,
                                   backend="pallas", route="classic")


def _plain_sgd(params, grads, mom, lr, nesterov):
    from laser_tpu_torch.ops import optim

    for p, g, mm in zip(*(optim.tree_leaves(t) for t in (params, grads, mom)), strict=True):
        optim.sgdm_update_plain(p, g, mm, lr=lr, mu=0.9, nesterov=nesterov)
    return params, mom


def _torch_optimizer(params, grads, kind):
    """torch.optim's fused AdamW or SGD over copies of the leaves (the
    library yardstick, weight decay 0), its step as a callable."""
    import inspect

    from laser_tpu_torch.ops.optim import tree_leaves

    leaves = [torch.nn.Parameter(p.detach().clone()) for p in tree_leaves(params)]
    for leaf, g in zip(leaves, tree_leaves(grads), strict=True):
        leaf.grad = g.clone()
    cls = torch.optim.AdamW if kind == "adamw" else torch.optim.SGD
    fused = "fused" in inspect.signature(cls).parameters
    kw = dict(lr=LR, weight_decay=0.0) if kind == "adamw" else dict(
        lr=LR, momentum=0.9, nesterov=kind == "sgd_nesterov")
    opt = cls(leaves, **kw, **({"fused": True} if fused else {"foreach": True}))
    return opt.step, (f"torch.optim.{cls.__name__}({'fused' if fused else 'foreach'}=True"
                      f"{', nesterov=True' if kind == 'sgd_nesterov' else ''}).step")


def _int_packed_check(plain, library, tag="gemm_packed int8", route_out=None):
    """Bits equal to the plain version and to the library call (and to
    the library's route, ``route_out``)."""
    bits = _bits_equal(tag)

    def check(got):
        err = bits(got, plain())
        same = torch.equal(got, library())
        print(f"  {tag}: bit-identical to torch._int_mm: {same}", flush=True)
        if not same:
            fail(f"{tag}: kernel and torch._int_mm differ")
        if route_out is not None:
            same = torch.equal(got, route_out)
            print(f"  {tag}: bit-identical to the int8 wgmma route: {same}", flush=True)
            if not same:
                fail(f"{tag}: the classic kernel and the int8 wgmma route differ")
        return err
    return check


def library_cases(spec):
    """The path's inputs, its counted run (the kernel routes), and one Table
    per case for the checks and timings after it."""
    from laser_tpu_torch import registry
    from laser_tpu_torch.models import transformer as tf
    from laser_tpu_torch.ops import optim
    from laser_tpu_torch.ops import stencil as ST
    from laser_tpu_torch.ops.gemm import prepacked as PK

    params = tf.init_transformer(0, dtype=torch.bfloat16, device=DEVICE, **MODEL)
    tokens = train_batch(MODEL["vocab"], TRAIN_BATCH, 0)
    _, grads = loss_and_grads(params, tokens, transformer_loss(MODEL["n_heads"]), plain=False)
    del tokens
    torch.cuda.empty_cache()
    leaves = optim.tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    print(f"  optimizer tree: {len(leaves)} leaves, {n_params} bf16 parameters "
          f"({n_params / 1e6:.1f} M)", flush=True)
    lr = torch.tensor(LR, device=DEVICE)
    m, v = optim.adamw_init(params)
    mom = optim.tree_map(torch.zeros_like, params)
    s0 = _clone_tree((params, m, v))

    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    u = torch.randn(STENCIL_N, STENCIL_N, generator=g, device=DEVICE)
    f = torch.zeros_like(u)
    packed_in = {}
    for dt in (torch.bfloat16, torch.float32):
        g.manual_seed(0)
        b = (torch.randn(PACKED_N, PACKED_N, generator=g, device=DEVICE) * 0.05).to(dt)
        a_list = [(torch.randn(PACKED_N, PACKED_N, generator=g, device=DEVICE) * 0.05).to(dt)
                  for _ in range(PACKED_A_COUNT)]
        packed_in[dt] = (a_list, b)
    g.manual_seed(0)
    a8, b8 = (torch.randint(-8, 8, (PACKED_N, PACKED_N), generator=g, device=DEVICE,
                            dtype=torch.int8) for _ in range(2))
    b8_cols = b8.t().contiguous().t()  # B column-major: _int_mm's (cuBLASLt's TN) layout

    # --- the counted run: every entry point through its kernel ---
    torch.cuda.synchronize()
    registry.reset_counts()
    optim.adamw_step(params, grads, m, v, 1, lr=lr, weight_decay=0.0, backend="pallas")
    s1 = _clone_tree((params, m, v))
    optim.adamw_step(params, grads, m, v, 3, lr=lr, weight_decay=0.1, backend="pallas")
    s3 = _clone_tree((params, m, v))
    t0 = _clone_tree((params, mom))
    optim.sgd_momentum_step(params, grads, mom, lr=lr, backend="pallas")
    t1 = _clone_tree((params, mom))
    optim.sgd_momentum_step(params, grads, mom, lr=lr, nesterov=True, backend="pallas")
    t2 = (params, mom)
    red = ST.stencil_solve(u, f, iters=STENCIL_ITERS, method="redblack")
    jac = ST.stencil_solve(u, f, iters=STENCIL_ITERS, method="jacobi")
    packed_out = {}
    for dt, (a_list, b) in packed_in.items():
        pb = PK.gemm_prepack_b(b, m_hint=PACKED_N)
        pas = [PK.gemm_prepack_a(a, n_hint=PACKED_N) for a in a_list]
        packed_out[dt] = (pas, pb, [PK.gemm_packed(PACKED_ALPHA, pa, pb) for pa in pas])
    pa8, pb8 = PK.gemm_prepack_a(a8, n_hint=PACKED_N), PK.gemm_prepack_b(b8, m_hint=PACKED_N)
    out8 = PK.gemm_packed(1, pa8, pb8)
    torch.cuda.synchronize()
    counts = registry.counts()
    # the per-leaf kernel asked for, outside the count, from the same states
    cp, cm = _clone_tree(t0)
    c1 = _sgd_classic(cp, grads, cm, lr, False)
    cp, cm = _clone_tree(t1)
    c2 = _sgd_classic(cp, grads, cm, lr, True)

    # --- checks and timings ---
    tree_bytes = {"adamw": 14 * n_params, "sgd": 10 * n_params}  # bf16: 7 and 5 streams
    sgd_classic_run = (lambda: _sgd_classic(params, grads, mom, lr, False))
    plain8 = (lambda: PK.gemm_packed_plain(1, pa8, pb8, 0.0, None, torch.int8, torch.int32,
                                           torch.int32))
    adamw_run = (lambda: optim.adamw_step(params, grads, m, v, 3, lr=lr, weight_decay=0.1,
                                          backend="pallas"))
    adamw_plain = (lambda: _plain_adamw(params, grads, m, v, 3, lr, 0.1))
    adamw_default = (lambda: optim.adamw_step(params, grads, m, v, 3, lr=lr, weight_decay=0.1))
    sgd_run = (lambda: optim.sgd_momentum_step(params, grads, mom, lr=lr, backend="pallas"))
    sgd_plain = (lambda: _plain_sgd(params, grads, mom, lr, False))
    sgd_default = (lambda: optim.sgd_momentum_step(params, grads, mom, lr=lr))

    def check_adamw(state_in, step, wd):
        def check(got):
            p_, m_, v_ = _clone_tree(state_in)
            return _tree_bits(f"adamw_update step {step} wd {wd}", got,
                              _plain_adamw(p_, grads, m_, v_, step, lr, wd))
        return check

    def check_sgd(state_in, nesterov, name="sgdm_multi"):
        def check(got):
            p_, mm = _clone_tree(state_in)
            return _tree_bits(f"{name} nesterov={nesterov}", got,
                              _plain_sgd(p_, grads, mm, lr, nesterov))
        return check

    def check_stencil(method):
        def check(got):
            return _bits_equal(f"stencil_solve {method}")(
                got, ST.stencil_sweeps_plain(u, f, STENCIL_ITERS, method))
        return check

    def check_packed(dt):
        pas, pb, outs_ = packed_out[dt]
        a_list, b = packed_in[dt]

        def check(got):
            worst = 0.0
            cpu_b = PK._pack(b.cpu(), pb.block[0], pb.block[1], "B")
            same = torch.equal(cpu_b.data.view(torch.uint8), pb.data.cpu().view(torch.uint8))
            print(f"  gemm_packed {DTYPE_TAGS[dt]}: packed B equals the CPU pack byte for byte: "
                  f"{same}", flush=True)
            if not same:
                fail("gemm_packed: the card's packed bytes differ from the CPU pack")
            for i, (pa, out) in enumerate(zip(pas, outs_, strict=True)):
                plain = PK.gemm_packed_plain(PACKED_ALPHA, pa, pb, 0.0, None, dt, torch.float32,
                                             dt)
                # fp32 product of the unpacked operands, one rounding to dt
                lib = (torch.matmul(a_list[i].float(), b.float()) * PACKED_ALPHA).to(dt)
                for tag, want in (("plain", plain), ("torch.matmul", lib)):
                    err, rel = rel_error(out, want)
                    print(f"  gemm_packed {DTYPE_TAGS[dt]} A{i} vs {tag}: max_abs_err {err:.3e} "
                          f"rel {rel:.3e} (bound {PACKED_REL[dt]:.1e})", flush=True)
                    if not (rel <= PACKED_REL[dt] and torch.isfinite(out.float()).all()):
                        fail(f"gemm_packed {DTYPE_TAGS[dt]}: rel error {rel:.3e}")
                    if tag == "plain":
                        worst = max(worst, err)
            return worst
        return check

    a_opt, a_call = _torch_optimizer(params, grads, "adamw")
    s_opt, s_call = _torch_optimizer(params, grads, "sgd")
    s_opt_n, s_call_n = _torch_optimizer(params, grads, "sgd_nesterov")
    cells = STENCIL_N * STENCIL_N
    interior = (STENCIL_N - 2) ** 2
    cases = [
        Table("adamw_update", "",
              f"{len(leaves)} leaves, {n_params} bf16 params, step 3, wd 0.1",
              run=adamw_run, plain=adamw_plain, check=check_adamw(s1, 3, 0.1),
              nbytes=tree_bytes["adamw"], flops=ADAMW_FLOPS * n_params, peak=spec.f32_tflops,
              library=a_opt, library_call=a_call, dtype=torch.bfloat16),
        Table("adamw_update", "step1", "the same tree, step 1, wd 0.0", run=adamw_run,
              plain=adamw_plain, check=check_adamw(s0, 1, 0.0), nbytes=tree_bytes["adamw"],
              flops=ADAMW_FLOPS * n_params, peak=spec.f32_tflops, dtype=torch.bfloat16),
        Table("sgdm_multi", "", f"{len(leaves)} leaves, {n_params} bf16 params, mu 0.9, "
              "one launch", run=sgd_run, plain=sgd_plain, check=check_sgd(t0, False),
              nbytes=tree_bytes["sgd"], flops=SGD_FLOPS * n_params, peak=spec.f32_tflops,
              library=s_opt, library_call=s_call, dtype=torch.bfloat16),
        Table("sgdm_multi", "nesterov", "the same tree, Nesterov",
              run=(lambda: optim.sgd_momentum_step(params, grads, mom, lr=lr, nesterov=True,
                                                   backend="pallas")),
              plain=(lambda: _plain_sgd(params, grads, mom, lr, True)),
              check=check_sgd(t1, True), nbytes=tree_bytes["sgd"], flops=SGD_FLOPS * n_params,
              peak=spec.f32_tflops, library=s_opt_n, library_call=s_call_n,
              dtype=torch.bfloat16),
        Table("sgdm_update", "", f"the same tree, mu 0.9, the per-leaf kernel asked for "
              f"({len(leaves)} launches)", run=sgd_classic_run, plain=sgd_plain,
              check=check_sgd(t0, False, "sgdm_update"), nbytes=tree_bytes["sgd"],
              flops=SGD_FLOPS * n_params, peak=spec.f32_tflops, library=s_opt,
              library_call=s_call, dtype=torch.bfloat16, counted=False),
        Table("sgdm_update", "nesterov", "the same tree, Nesterov, the per-leaf kernel asked for",
              run=(lambda: _sgd_classic(params, grads, mom, lr, True)),
              plain=(lambda: _plain_sgd(params, grads, mom, lr, True)),
              check=check_sgd(t1, True, "sgdm_update"), nbytes=tree_bytes["sgd"],
              flops=SGD_FLOPS * n_params, peak=spec.f32_tflops, library=s_opt_n,
              library_call=s_call_n, dtype=torch.bfloat16, counted=False),
        Table("gemm_packed_i8_wgmma", "", f"{PACKED_N}^3 int8 -> int32, randint(-8, 8), "
              f"alpha 1, B packed once (tiles {pa8.block[0]} x {pb8.block[1]} x "
              f"{pb8.block[0]}), B's K-major twin",
              run=(lambda: PK.gemm_packed(1, pa8, pb8)), plain=plain8,
              check=_int_packed_check(plain8, lambda: torch._int_mm(a8, b8_cols)),
              nbytes=2 * PACKED_N * PACKED_N + 4 * PACKED_N * PACKED_N,
              flops=2 * PACKED_N ** 3, peak=spec.int8_tops,
              library=(lambda: torch._int_mm(a8, b8_cols)),
              library_call="torch._int_mm (cuBLASLt int8) on the unpacked operands, B "
              "column-major", dtype=torch.int8),
    ]
    for method, slot in (("redblack", ""), ("jacobi", "jacobi")):
        cases.append(Table(
            "stencil_sweep", slot,
            f"{STENCIL_N}^2 f32, f = 0, {STENCIL_ITERS} {method} iterations",
            run=(lambda mt=method: ST.stencil_solve(u, f, iters=STENCIL_ITERS, method=mt)),
            plain=(lambda mt=method: ST.stencil_sweeps_plain(u, f, STENCIL_ITERS, mt)),
            check=check_stencil(method), nbytes=3 * cells * 4,
            flops=STENCIL_FLOPS * interior * STENCIL_ITERS, peak=spec.f32_tflops))
    def check_classic(dt):
        def check(got):
            pas, pb, outs_ = packed_out[dt]
            want = PK.gemm_packed_plain(PACKED_ALPHA, pas[0], pb, 0.0, None, dt, torch.float32,
                                        dt)
            err = _rel_check(f"gemm_packed {DTYPE_TAGS[dt]} A0, the classic kernels asked for, "
                             "vs plain", PACKED_REL[dt])(got, want)
            if dt == torch.float32:  # the simt route sums in the classic kernel's order
                same = torch.equal(got, outs_[0])
                print(f"  gemm_packed f32 A0: the simt route's bits equal the classic "
                      f"kernels': {same}", flush=True)
                if not same:
                    fail("gemm_packed f32: the simt and classic routes' bits differ")
            return err
        return check

    # the routes the library picks (bf16: wgmma; f32: simt), then both on
    # the classic kernels asked for, in the same run
    classic_out = {dt: PK.gemm_packed(PACKED_ALPHA, packed_out[dt][0][0], packed_out[dt][1],
                                      route="classic")
                   for dt in (torch.float32, torch.bfloat16)}
    classic8 = PK.gemm_packed(1, pa8, pb8, route="classic")
    for name, dt, slot, route in (("gemm_packed_wgmma", torch.bfloat16, "", None),
                                  ("gemm_packed_simt", torch.float32, "", None),
                                  ("gemm_packed", torch.float32, "", "classic"),
                                  ("gemm_packed", torch.bfloat16, "bf16", "classic")):
        pas, pb, _ = packed_out[dt]
        n3 = PACKED_N ** 3
        cases.append(Table(
            name, slot, f"{PACKED_N}^3 {DTYPE_TAGS[dt]}, alpha 0.05, B packed once, "
            f"{PACKED_A_COUNT} A (tiles {pas[0].block[0]} x {pb.block[1]} x {pb.block[0]})"
            + (", the classic kernels asked for" if route else ""),
            run=(lambda pa=pas[0], pb=pb, r=route: PK.gemm_packed(PACKED_ALPHA, pa, pb, route=r)),
            plain=(lambda pa=pas[0], pb=pb, dt=dt: PK.gemm_packed_plain(
                PACKED_ALPHA, pa, pb, 0.0, None, dt, torch.float32, dt)),
            check=check_classic(dt) if route else check_packed(dt),
            nbytes=3 * PACKED_N * PACKED_N * dt.itemsize,
            flops=2 * n3, peak=spec.bf16_tflops if dt == torch.bfloat16 else spec.f32_tflops,
            library=(lambda a=packed_in[dt][0][0], b=packed_in[dt][1]: torch.matmul(a, b)),
            library_call="torch.matmul on the unpacked operands (cuBLAS, TF32 off)", dtype=dt))
    # the int8 product on the classic kernel asked for (packed_i8_kernel, WMMA s8)
    cases.append(Table(
        "gemm_packed", "int8", f"{PACKED_N}^3 int8 -> int32, randint(-8, 8), alpha 1, B packed "
        f"once (tiles {pa8.block[0]} x {pb8.block[1]} x {pb8.block[0]}), the classic kernel "
        "asked for", run=(lambda: PK.gemm_packed(1, pa8, pb8, route="classic")), plain=plain8,
        check=_int_packed_check(plain8, lambda: torch._int_mm(a8, b8_cols),
                                "gemm_packed int8 classic", out8),
        nbytes=2 * PACKED_N * PACKED_N + 4 * PACKED_N * PACKED_N,
        flops=2 * PACKED_N ** 3, peak=spec.int8_tops,
        library=(lambda: torch._int_mm(a8, b8_cols)),
        library_call="torch._int_mm (cuBLASLt int8) on the unpacked operands, B column-major",
        dtype=torch.int8, counted=False))
    outs = [s3, s1, t1, t2, c1, c2, out8, red, jac, packed_out[torch.bfloat16][2][0],
            packed_out[torch.float32][2][0], classic_out[torch.float32],
            classic_out[torch.bfloat16], classic8]
    extra = dict(adamw_default=adamw_default, sgd_default=sgd_default, packed_in=packed_in,
                 leaves=leaves, int8=(a8, b8, pa8, pb8),
                 packed_tiles={dt: (po[0][0].block, po[1].block)
                               for dt, po in packed_out.items()})
    return counts, cases, outs, extra


def phase_library(spec):
    from laser_tpu_torch.ops import stencil as ST
    from laser_tpu_torch.ops.gemm import prepacked as PK

    print("phase 16: the library surface at full size (adamw_step / sgd_momentum_step "
          "backend='pallas', stencil_solve, the prepacked GEMM)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"  card: {smi.stdout.strip()}", flush=True)
    counts, cases, outs, extra = library_cases(spec)
    print(f"  counts {json.dumps({k: v for k, v in counts.items() if any(v.values())})}",
          flush=True)
    for k in LIBRARY_KERNELS:
        if counts[k]["launches"] == 0:
            fail(f"library: {k} never launched")
    for k in LIBRARY_REPLACED:
        if counts[k]["launches"]:
            fail(f"library: the replaced kernel {k} launched on the path")
    if any(c["plain_calls"] for c in counts.values()):
        fail(f"library: a plain version ran: {counts}")
    # every check first: the timings below run the updates in place again
    errors = {id(case): case.check(got) for case, got in zip(cases, outs, strict=True)}
    entries = check_and_time(spec, cases, outs, lambda case, got: errors[id(case)])

    # the default backends, and what the stencil and the packed GEMM need beside
    for name, key in (("adamw_update", "adamw_default"), ("sgdm_multi", "sgd_default")):
        dms = cuda_ms(extra[key], reps=5)
        entries[name]["default_backend_ms"] = dms
        print(f"  {name}: the default backend (laser_tpu's XLA expression in torch) "
              f"{dms:.4f} ms a step", flush=True)
    for slot, method in (("", "redblack"), ("jacobi", "jacobi")):
        e = entries["stencil_sweep"][slot] if slot else entries["stencil_sweep"]
        ms = e["ms"]
        stream = (2 if method == "redblack" else 1) * STENCIL_ITERS * (
            (2.5 if method == "redblack" else 3) * STENCIL_N * STENCIL_N * 4)
        e["streaming_bound_ms"] = stream / (spec.hbm_gbps * 1e9) * 1e3
        e["sweeps_per_s"] = STENCIL_ITERS / (ms / 1e3)
        e["effective_gbps"] = STENCIL_ITERS * 2 * STENCIL_N * STENCIL_N * 4 / ms / 1e6
        print(f"  stencil {method}: {e['sweeps_per_s']:.1f} sweeps/s, {e['effective_gbps']:.1f} "
              f"GB/s effective (bench.py's iters * 2 * size * 4 / t); bound {e['bound_ms']:.4f} "
              f"ms ({e['bound_by']}: u, f read once and u written once, "
              f"{STENCIL_FLOPS} flops a cell update), streaming bound of a design that is "
              f"not resident {e['streaming_bound_ms']:.4f} ms", flush=True)
    # each update and the stencil under the profiler: the device time a
    # call, as the mean time of the kernel's launches the trace kept times
    # its launches a call; beside it ``trace_busy_ms``, the trace's busy time
    # a call, which counts only the launches it kept. Late in this run a
    # session's trace may drop its first ~18 launches (a fresh process
    # keeps them all: scripts/trace_launches.py), so SGD's one launch a step
    # runs SGD_PROFILE_STEPS times; should the trace keep none of them, its
    # device time stays its 20 in a row (``batched_ms``)
    for case, kernel, launches, calls in (
            (cases[0], "adamw_kernel", len(extra["leaves"]), 1),
            (cases[2], "sgdm_multi_kernel", 1, SGD_PROFILE_STEPS),
            (cases[4], "sgdm_kernel", len(extra["leaves"]), 1),
            (cases[7], "stencil_kernel", 2 * STENCIL_ITERS, 1)):
        multi = kernel == "sgdm_multi_kernel"
        prof = profile_step(lambda run=case.run, n=calls: [run() for _ in range(n)],
                            f"{calls} {case.name} call{'s' if calls > 1 else ''}",
                            require=not multi)
        hits = [r for r in prof["top"] if kernel in r["kernel"]] if prof else []
        kept = sum(r["calls"] for r in hits)
        e = entries[case.name]
        e["profile_kept"] = [kept, launches * calls]
        if not kept:
            if not multi:
                fail(f"library: the trace kept no {kernel} launch")
            print(f"  the trace kept none of its {calls} launches", flush=True)
            continue
        e["device_ms"] = sum(r["ms"] for r in hits) / kept * launches
        e["trace_busy_ms"] = prof["busy_ms"] / calls
        print(f"  {kept} of its {launches * calls} kernel launches kept in the trace; device "
              f"{e['device_ms']:.4f} ms a call", flush=True)
    for case in cases[2], cases[4]:  # the host's share of an SGD step
        e = entries[case.name]
        e["host_us"] = host_us(case.run, n=20)
        print(f"  {case.name}: host {e['host_us']:.1f} us a step", flush=True)
    u = torch.zeros(16, 16, device=DEVICE)
    u[1:-1, 1:-1] = torch.randn(14, 14, generator=torch.Generator(device=DEVICE).manual_seed(0),
                                device=DEVICE)
    conv = ST.stencil_solve(u, iters=500, method="redblack")[1:-1, 1:-1].abs().max().item()
    print(f"  stencil 16^2, zero edges, f = 0, 500 red-black iterations: interior max "
          f"{conv:.3e} (bound 1e-4)", flush=True)
    if not conv < 1e-4:
        fail(f"stencil did not converge: {conv}")
    for dt, name in ((torch.bfloat16, "gemm_packed_wgmma"), (torch.float32, "gemm_packed_simt")):
        e = entries[name]
        a_list, b = extra["packed_in"][dt]
        (bm, bk), (_, bn) = extra["packed_tiles"][dt]
        tiles = PK.GemmTiles(bm, bn, bk, 0)
        e["pack_a_ms"] = cuda_ms(lambda: PK.gemm_prepack_a(a_list[0], tiles=tiles), reps=10)
        e["pack_b_ms"] = cuda_ms(lambda: PK.gemm_prepack_b(b, tiles=tiles), reps=10)
        e["blocks_route"] = PK.blocks_route(dt, bm, bn, bk)
        tflops = 2 * PACKED_N ** 3 / e["ms"] / 1e9
        print(f"  gemm_packed {DTYPE_TAGS[dt]}: pack A {e['pack_a_ms']:.4f} ms, pack B "
              f"{e['pack_b_ms']:.4f} ms, multiply {e['ms']:.4f} ms ({tflops:.1f} TFLOP/s), "
              f"blocks route {e['blocks_route']}", flush=True)
    # the int8 pack: B's K-major twin is paid once per packed B
    a8, b8, pa8, pb8 = extra["int8"]
    e = entries["gemm_packed_i8_wgmma"]
    tiles = PK.GemmTiles(pa8.block[0], pb8.block[1], pb8.block[0], 0)
    e["pack_a_ms"] = cuda_ms(lambda: PK.gemm_prepack_a(a8, tiles=tiles), reps=10)
    e["pack_b_ms"] = cuda_ms(lambda: PK.gemm_prepack_b(b8, tiles=tiles), reps=10)
    e["kmajor_twin_ms"] = cuda_ms(lambda: pb8.data.transpose(-1, -2).contiguous(), reps=10)
    e["kmajor_twin_bytes"] = pb8.kmajor.numel() * pb8.kmajor.element_size()
    tops = 2 * PACKED_N ** 3 / e["batched_ms"] / 1e9
    print(f"  gemm_packed int8: pack A {e['pack_a_ms']:.4f} ms, pack B {e['pack_b_ms']:.4f} ms "
          f"(of which B's K-major twin {e['kmajor_twin_ms']:.4f} ms, "
          f"{e['kmajor_twin_bytes']} bytes held beside the packed B), multiply "
          f"{e['batched_ms']:.4f} ms 20 in a row ({tops:.1f} TOP/s)", flush=True)
    return {"library": counts}, entries



def llama_train_params(n_layers: int, seed: int):
    """Phase 7's model at ``n_layers``, bf16, with its rope tables."""
    from laser_tpu_torch.models.llama import init_llama
    from laser_tpu_torch.ops.rope import rope_tables

    cfg = dict(LLAMA, n_layers=n_layers)
    params = init_llama(seed, dtype=torch.bfloat16, device=DEVICE,
                        max_len=LLAMA_ROPE["max_len"], **cfg)
    params["rope_cos"], params["rope_sin"] = rope_tables(
        LLAMA_ROPE["max_len"], LLAMA["d_model"] // LLAMA["n_heads"], base=LLAMA_ROPE["base"],
        device=DEVICE)
    return params


def phase_llama_train():
    from laser_tpu_torch import registry
    from laser_tpu_torch.models import llama
    from laser_tpu_torch.ops.optim import tree_leaves

    print("phase 17: llama training, Llama-3-8B widths, 8 layers bf16, batch 4x1024",
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"  card: {smi.stdout.strip()}", flush=True)
    kw = dict(n_heads=LLAMA["n_heads"], n_kv_heads=LLAMA["n_kv_heads"])
    params = llama_train_params(LLAMA["n_layers"], 0)
    n_params = sum(t.numel() for k, v in params.items() if not k.startswith("rope_")
                   for t in tree_leaves(v))
    tokens = train_batch(LLAMA["vocab"], LLAMA_TRAIN_BATCH, 0)
    rows = LLAMA_TRAIN_BATCH[0] * (LLAMA_TRAIN_BATCH[1] - 1)
    logit_bytes = 2 * rows * 128 * math.ceil(LLAMA["vocab"] / 128) * 2
    print(f"  {n_params / 1e9:.3f} B trained params; {rows} target rows; logits + residual "
          f"{logit_bytes / 1e9:.3f} GB past the 1 GiB budget: the chunked branch", flush=True)
    if logit_bytes <= 1024 ** 3:
        fail("phase 17's loss would take the materialized branch")
    check_routes(params, tokens, llama_loss(LLAMA), TRAIN_LOSS_REL, TRAIN_GRAD_REL, "fro")
    torch.cuda.empty_cache()

    opt = llama.llama_train_init(params)

    def step(i, **extra):
        return llama.llama_train_step(params, opt, tokens, i, **kw, **{
            "lr": LR, "weight_decay": WD, **extra})[2]

    def eval_loss():
        with torch.no_grad():
            return llama.llama_lm_loss(params, tokens, **kw).item()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_counts()
    eval0 = eval_loss()
    losses, times = [], []
    for i in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(i).item())  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    eval6 = eval_loss()
    counts = registry.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  counts {json.dumps({k: v for k, v in counts.items() if any(v.values())})}",
          flush=True)
    check_counts(counts, LLAMA_TRAIN_KERNELS, "llama_train")
    print(f"  step losses {[round(x, 5) for x in losses]}", flush=True)
    print(f"  eval loss before step 1 {eval0:.6f}, after step {TRAIN_STEPS} {eval6:.6f}",
          flush=True)
    if not (math.isfinite(eval0) and math.isfinite(eval6) and eval6 < eval0):
        fail(f"llama eval loss did not fall: {eval0} -> {eval6}")
    step_ms = statistics.median(times[1:])
    print(f"  step ms (median of steps 2-{TRAIN_STEPS}) {step_ms:.2f} "
          f"(all {[round(t, 2) for t in times]}); {rows / step_ms * 1e3:.1f} training "
          f"tokens/s ({rows} target tokens per step); peak memory {peak_gb:.3f} GB",
          flush=True)

    # remat at lr 0 and no decay leaves the weights as they are, so the next
    # step (profiled, no remat) starts from the same weights
    registry.reset_counts()
    rloss = step(TRAIN_STEPS + 1, lr=0.0, weight_decay=0.0, remat=True).item()
    rcounts = registry.counts()
    registry.reset_counts()
    out = {}
    prof = profile_step(lambda: out.setdefault("loss", step(TRAIN_STEPS + 2)))
    pcounts = registry.counts()
    nloss = out["loss"].item()
    rel = abs(rloss - nloss) / abs(nloss)
    extra = {k: rcounts[k]["launches"] - pcounts[k]["launches"]
             for k in ("flash_attention_mma", "norm_vec")}
    print(f"  remat step loss {rloss:.6f}, the same weights without remat {nloss:.6f}: rel "
          f"{rel:.3e} (bound {TRAIN_LOSS_REL:.0e}); launches with remat minus without "
          f"{extra} (a block's flash forward and its two norms again)", flush=True)
    if not rel <= TRAIN_LOSS_REL:
        fail(f"remat step loss {rloss} vs {nloss}")
    check_counts(rcounts, LLAMA_TRAIN_KERNELS, "llama_train remat")
    if extra != {"flash_attention_mma": LLAMA["n_layers"], "norm_vec": 2 * LLAMA["n_layers"]}:
        fail(f"remat relaunched {extra}")
    del params, opt, out
    torch.cuda.empty_cache()

    # mixed precision: fp32 masters and moments at 4 layers
    print(f"  llama_train_step_mp at {LLAMA_MP_LAYERS} layers: bf16 compute tree, fp32 "
          "masters and moments", flush=True)
    params = llama_train_params(LLAMA_MP_LAYERS, 1)
    with torch.no_grad():
        bf16_loss = llama.llama_lm_loss(params, tokens, **kw).item()
    torch.cuda.reset_peak_memory_stats()
    state = llama.llama_train_init_mp(params)
    before = params["unembed"].clone()
    registry.reset_counts()
    _, state, mp_loss = llama.llama_train_step_mp(params, state, tokens, 1, lr=LR,
                                                  weight_decay=WD, **kw)
    mp_loss = mp_loss.item()
    mp_peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts(registry.counts(), LLAMA_TRAIN_KERNELS, "llama_train mp")
    rel = abs(mp_loss - bf16_loss) / abs(bf16_loss)
    moved = not torch.equal(params["unembed"], before)
    print(f"  mp step loss {mp_loss:.6f}, value-only loss of the same bf16 weights "
          f"{bf16_loss:.6f}: rel {rel:.3e} (bound {TRAIN_LOSS_REL:.0e}); weights moved "
          f"{moved}; peak memory {mp_peak:.3f} GB", flush=True)
    if not (math.isfinite(mp_loss) and rel <= TRAIN_LOSS_REL and moved):
        fail(f"mixed-precision step: loss {mp_loss} vs {bf16_loss}, moved {moved}")
    del params, state
    torch.cuda.empty_cache()
    return {"llama_train": counts}, {
        "step_ms": step_ms, "step_ms_all": times, "tokens_per_step": rows,
        "tokens_per_s": rows / step_ms * 1e3, "peak_gb": peak_gb, "trained_params": n_params,
        "eval_loss": [eval0, eval6], "losses": losses, "remat_loss": [rloss, nloss],
        "remat_extra_launches": extra, "profile": prof, "mp_loss": [mp_loss, bf16_loss],
        "mp_peak_gb": mp_peak}

def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from laser_tpu_torch import device_info, registry
    # importing the paths' modules registers every kernel
    from laser_tpu_torch.models import cnn, mlp, transformer  # noqa: F401
    from laser_tpu_torch.ops import (foreach, optim, quant, reductions, stencil,  # noqa: F401
                                     strided, transpose)
    from laser_tpu_torch.serving import engine  # noqa: F401

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    spec = device_info.detect()

    t0 = time.perf_counter()
    registry.load_library()
    print(f"phase 1: kernels built/loaded in {time.perf_counter() - t0:.1f} s "
          f"({registry.library_path().parent.name})", flush=True)

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        print(f"  ({phase.__name__}: {time.perf_counter() - t:.1f} s; "
              f"{time.perf_counter() - t0:.1f} s since the build started)", flush=True)
        return out

    record = timed(phase_kernels, spec)
    serve_counts, engine = timed(phase_slice)
    timed(phase_f32)
    train_counts, train = timed(phase_train)
    timed(phase_train_f32)
    llama_counts, llama = timed(phase_llama)
    timed(phase_llama_f32)
    s1_counts, s1 = timed(phase_spec_s1)
    s2_counts, s2 = timed(phase_spec_s2)
    timed(phase_spec_f32)
    cnn_counts, cnn_result = timed(phase_cnn)
    prim_counts, prim_record, prim_result = timed(phase_primitives, spec)
    record.update({k: v for k, v in prim_record.items() if k != "lux_gemm"})
    record["gemm_simt"]["lux_relu_bias"] = prim_record["lux_gemm"]
    layout_counts, layout_record, layout_result = timed(phase_layout, spec)
    record.update(layout_record)
    table_counts, table_record = timed(phase_gemm_table, spec)
    for k, v in table_record.items():
        record.setdefault(k, {}).update(v)
    library_counts, library_record = timed(phase_library, spec)
    for k, v in library_record.items():
        record.setdefault(k, {}).update(v)
    llama_train_counts, llama_train = timed(phase_llama_train)

    kernels = []
    for name, k in registry.KERNELS.items():
        r = record[name]
        by_path = {"serving": serve_counts[name]["launches"],
                   "training": train_counts[name]["launches"],
                   **{tag: c[name]["launches"] for tag, c in llama_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in s1_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in s2_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in cnn_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in prim_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in layout_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in table_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in library_counts.items()},
                   **{tag: c[name]["launches"] for tag, c in llama_train_counts.items()}}
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **r})
    print(json.dumps({"card": card, "engine": engine, "train": train, "llama": llama,
                      "spec_s1": s1, "spec_s2": s2, "cnn": cnn_result,
                      "primitives": prim_result, "layout": layout_result,
                      "llama_train": llama_train}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
