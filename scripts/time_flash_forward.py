#!/usr/bin/env python3
"""Time laser_tpu_torch's value-only flash forward in two source trees, in
turns on one CUDA card.

    python3 scripts/time_flash_forward.py TREE_A TREE_B

Each TREE is the root of a checkout (for example the parent commit unpacked
with ``git archive``, and this one). The trees run in the order A, B, B, A,
each in its own process (the two packages share a name), so a drift of the
card over the run falls on both. Every process builds its tree's kernels
into that tree's ``build/`` and times ``attention(q, k, v, causal=True)``
under ``no_grad`` at the serving prefill's shape (8 x 16 heads, S 512, D
128, bf16) two ways, with CUDA events:

- ``per_call_ms``: median over 20 calls of one call between two events, as
  chip_smoke.py phase 2 times it (the host's work in the wrapper included);
- ``batched_ms``: 50 calls between two events, over 50, median of 5 runs
  (the device's time: the host enqueues faster than the kernel runs).

Prints one JSON line per run, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPE = (8, 16, 512, 128)


def _time_tree(tree: str) -> dict:
    import torch

    sys.path.insert(0, tree)
    import laser_tpu_torch
    from laser_tpu_torch import registry
    from laser_tpu_torch.ops.attention import attention

    pkg = os.path.realpath(os.path.dirname(laser_tpu_torch.__file__))
    if not pkg.startswith(os.path.realpath(tree) + os.sep):
        raise SystemExit(f"imported {pkg}, not the package under {tree}")
    registry.load_library()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))

    def call():
        attention(q, k, v, causal=True)

    def events(n: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            call()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    with torch.no_grad():
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        per_call = statistics.median(events(1) for _ in range(20))
        batched = statistics.median(events(50) for _ in range(5))
    return {"tree": tree, "per_call_ms": per_call, "batched_ms": batched}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_time_tree(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(t) for t in sys.argv[1:])
    for tree in (a, b, b, a):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                            cwd=tree).returncode
        if rc:
            return rc
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
