#!/usr/bin/env python3
"""Drive laser_tpu_torch's serving path on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and the result line is not
printed:

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from laser_tpu_torch/csrc (timed).
2. Each of the four kernels at the serving slice's full-width shapes in bf16,
   and once in f32: compare it with its plain PyTorch version on the card
   against a stated bound, and time both with CUDA events.
3. The slice: ServingEngine over the 8-layer d2048 bf16 transformer with
   random weights from a seed, 12 greedy requests through 8 slots. Checks
   token counts and range, that every kernel launched and no plain version
   ran, the first-token logits of two requests against the plain dense
   forward, and prints the token agreement with the plain greedy_decode.
4. The same engine at 2 layers d512 in f32: its tokens must equal the plain
   f32 greedy_decode for every request.

The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# stated bounds: max |kernel - plain| / max |plain|, per dtype. bf16 outputs
# round to 8 mantissa bits, so two correct fp32-accumulating paths that sum
# in different orders may differ by one bf16 ulp of the largest value
# (2^-7 relative); f32 differs only by summation order.
REL_BOUND = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# first-token logits of the full bf16 model, engine vs plain dense forward:
# the two paths round different intermediates to bf16 through 8 layers
LOGITS_REL_BOUND = 5e-2

MODEL = dict(n_layers=8, d_model=2048, n_heads=16, d_ff=8192, vocab=8192)
MODEL_F32 = dict(n_layers=2, d_model=512, n_heads=4, d_ff=2048, vocab=8192)
N_REQUESTS, NEW_TOKENS = 12, 64
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


def compare(name, got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite output")
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    rel = err / scale
    bound = REL_BOUND[dtype]
    print(f"  {name} [{str(dtype).replace('torch.', '')}]: max_abs_err {err:.3e} "
          f"rel {rel:.3e} (bound {bound:.0e})", flush=True)
    if not rel <= bound:
        fail(f"{name}: relative error {rel:.3e} > {bound:.0e}")
    return err


def kernel_cases(dtype, full: bool):
    """(name, kernel call, plain call, shape note) at the slice's shapes."""
    from laser_tpu_torch.ops.attention import attention, attention_reference
    from laser_tpu_torch.ops.gemm import linear, linear_reference
    from laser_tpu_torch.ops.norm import layer_norm, layer_norm_reference
    from laser_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_reference)

    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * std).to(dtype)

    if full:  # prefill widths of the 8L d2048 model; decode 8 slots x 16 pages
        M, K, N = 4096, 2048, 8192
        rows, cols = 4096, 2048
        BH, S, D = 8 * 16, 512, 128
        slots, H, hd, ps, pages = 8, 16, 128, 64, 16
    else:
        M, K, N = 256, 512, 2048
        rows, cols = 256, 512
        BH, S, D = 8, 200, 128
        slots, H, hd, ps, pages = 4, 4, 128, 64, 4
    x, w, bias = rnd(M, K), rnd(K, N, std=K ** -0.5), rnd(N, std=0.1)
    xn, gam, bet = rnd(rows, cols), rnd(cols), rnd(cols, std=0.1)
    q, k, v = rnd(BH, S, D), rnd(BH, S, D), rnd(BH, S, D)
    P = slots * pages + 1
    qd, kp, vp = rnd(slots, H, hd), rnd(P, H, ps, hd), rnd(P, H, ps, hd)
    perm = torch.randperm(P - 1, generator=g, device=DEVICE)
    tables = perm[:slots * pages].reshape(slots, pages).int().contiguous()
    lengths = torch.linspace(0, pages * ps, slots, device=DEVICE).int()
    return [
        ("gemm", lambda: linear(x, w, bias, "gelu"),
         lambda: linear_reference(x, w, bias, "gelu"), f"M{M} K{K} N{N} bias+gelu"),
        ("norm", lambda: layer_norm(xn, gam, bet),
         lambda: layer_norm_reference(xn, gam, bet), f"{rows}x{cols} layer"),
        ("flash_attention", lambda: attention(q, k, v, causal=True),
         lambda: attention_reference(q, k, v, causal=True), f"BH{BH} S{S} D{D} causal"),
        ("paged_attention", lambda: paged_attention(qd, kp, vp, tables, lengths),
         lambda: paged_attention_reference(qd, kp, vp, tables, lengths),
         f"slots{slots} H{H} hd{hd} ps{ps} pages{pages} lengths 0..{pages * ps}"),
    ]


def decode_gemm_case():
    """The decode-regime GEMM (8 rows against the wqkv weight), bf16."""
    from laser_tpu_torch.ops.gemm import linear, linear_reference

    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    x = torch.randn((8, 2048), generator=g, device=DEVICE).bfloat16()
    w = (torch.randn((2048, 6144), generator=g, device=DEVICE) * 2048 ** -0.5).bfloat16()
    b = torch.zeros((6144,), device=DEVICE, dtype=torch.bfloat16)
    return lambda: linear(x, w, b), lambda: linear_reference(x, w, b)


def phase_kernels():
    print("phase 2: kernels vs plain versions", flush=True)
    record = {}
    for dtype, full in ((torch.bfloat16, True), (torch.float32, False)):
        for name, kern, plain, shape in kernel_cases(dtype, full):
            err = compare(f"{name} {shape}", kern(), plain(), dtype)
            if full:
                ms, pms = cuda_ms(kern), cuda_ms(plain)
                print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
                record[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                "shape": shape}
    kern, plain = decode_gemm_case()
    err = compare("gemm M8 K2048 N6144 bias (decode)", kern(), plain(), torch.bfloat16)
    ms, pms = cuda_ms(kern), cuda_ms(plain)
    print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
    record["gemm"]["decode"] = {"shape": "M8 K2048 N6144 bias", "max_abs_err": err,
                                "ms": ms, "plain_ms": pms}
    return record


def traffic(vocab: int):
    rs = np.random.RandomState(0)
    lens = rs.randint(100, 513, size=N_REQUESTS)
    return [rs.randint(0, vocab, size=n).astype(np.int32) for n in lens]


def serve(params, n_heads, prompts, keep_first_logits=False):
    from laser_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(page_size=64, max_seqs=8, max_pages_per_seq=16, n_pages=129,
                        prefill_buckets=(128, 256, 512))
    eng = ServingEngine(params, n_heads=n_heads, cfg=cfg,
                        keep_first_logits=keep_first_logits)
    ids = [eng.add_request(p, NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, [out[i] for i in ids], wall


def check_tokens(outs, vocab):
    for i, toks in enumerate(outs):
        if len(toks) != NEW_TOKENS or not all(0 <= t < vocab for t in toks):
            fail(f"request {i}: {len(toks)} tokens, range "
                 f"[{min(toks, default=-1)}, {max(toks, default=-1)}]")


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
    for name, c in counts.items():
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            fail(f"{name}: launches {c['launches']}, plain calls {c['plain_calls']}")
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
    return counts, {"wall_s": wall, "tokens": ntok, "tokens_per_s": ntok / wall}


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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops import attention, norm, paged_attention  # noqa: F401
    from laser_tpu_torch.ops.gemm import kernel  # noqa: F401

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    registry.load_library()
    print(f"phase 1: kernels built/loaded in {time.perf_counter() - t0:.1f} s "
          f"({registry.library_path().parent.name})", flush=True)

    record = phase_kernels()
    counts, engine = phase_slice()
    phase_f32()

    kernels = []
    for name, k in registry.KERNELS.items():
        r = record[name]
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": counts[name]["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "shape": r["shape"],
                        **({"decode": r["decode"]} if "decode" in r else {})})
    print(json.dumps({"card": card, "engine": engine}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
