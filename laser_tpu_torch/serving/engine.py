"""Continuous-batching serving engine over a paged KV cache (port of
laser_tpu/serving/engine.py).

Two model families: ``model="transformer"`` (``models.transformer``: MHA,
layer norms, tied embeddings) and ``model="llama"`` (``models.llama``:
RMSNorm, RoPE, GQA, SwiGLU, untied embeddings; ``n_kv_heads`` is inferred
from ``wkv``).

Host (this engine): request queue, slot and page allocation from a free
list, block tables, stop conditions, preemption. Device: one batched decode
step for every slot per ``step()`` (fused linears, the paged-attention
kernel, the K/V row scatter) and one batched flash prefill per group of
same-bucket admissions. Unlike laser_tpu, which donates its pools to each
jitted step and gets them back, the port updates the KV pool IN PLACE.

Every generated token is identical to ``models.transformer.greedy_decode``
(``models.llama.llama_generate``) on that request alone under greedy
sampling, however requests interleave (tested against laser_tpu's engine as
well).

Quantisation, as in laser_tpu: ``weight_quant`` (``True``/``"int8"``:
per-column int8 block weights, a plain product then the scales; ``"int4"``:
group-wise int4 through the ``w4_gemm`` kernel, ``weight_quant_group`` rows
per scale) quantizes every block linear of either family, embeddings and
the unembedding staying full precision; ``kv_quant`` keeps the KV pages in
int8 with a per-(page, kv head, token) f32 scale, quantized at the scatter
and read by the paged kernel's int8 variant.

Ported: ``decode_burst=1``, page allocation, the trash page, preemption,
per-request greedy/temperature/top-k/top-p sampling, both families,
``weight_quant``, ``kv_quant``. Not ported, each raising
``NotImplementedError``: ``prefix_cache``, speculative decoding
(``spec_gamma``/``draft_params``/``draft_weight_quant``),
``pipeline_bursts``, ``decode_burst > 1``, ``mesh``, ``window``, and
chunked prefill of a prompt longer than the largest bucket.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import pin_fp32_matmul
from ..models.transformer import split_heads
from ..ops.attention import attention, attention_gqa
from ..ops.gemm import gemm_ad, linear
from ..ops.gemm.int4_kernel import gemm_w4, quantize_int4
from ..ops.norm import layer_norm, rms_norm
from ..ops.paged_attention import paged_attention, quantize_kv
from ..ops.rope import apply_rope, apply_rope_at
from ..ops.sampling import sample_logits_batch


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """laser_tpu's ServingConfig, field for field (see its docstring)."""
    page_size: int = 64
    n_pages: int = 256          # shared pool; the last page is the trash page
    max_seqs: int = 8           # concurrent sequences (decode batch)
    max_pages_per_seq: int = 16
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    kv_quant: bool = False
    weight_quant: "bool | str" = False
    weight_quant_group: int = 64
    prefix_cache: bool = False
    decode_burst: int = 1
    spec_gamma: int = 0
    draft_weight_quant: "bool | str" = False
    pipeline_bursts: bool = False


def _check_ported(cfg: ServingConfig, mesh, window, draft_params):
    unported = []
    for name in ("prefix_cache", "pipeline_bursts", "draft_weight_quant"):
        if getattr(cfg, name):
            unported.append(f"{name}={getattr(cfg, name)!r}")
    if cfg.decode_burst != 1:
        unported.append(f"decode_burst={cfg.decode_burst} (only 1)")
    if cfg.spec_gamma or draft_params is not None:
        unported.append("speculative decoding (spec_gamma / draft_params)")
    if mesh is not None:
        unported.append("mesh (tensor-parallel serving)")
    if window is not None:
        unported.append("window (sliding-window attention)")
    if unported:
        raise NotImplementedError("not ported to laser_tpu_torch yet: "
                                  + "; ".join(unported))


class PagedKVCache:
    """Shared KV page pool on the device plus the host-side allocator.

    pools: (L, 2, P, Hkv, ps, hd) tensor in ``dtype``, or int8 with
    ``cfg.kv_quant``; scales: (L, 2, P, Hkv, ps) f32 with ``kv_quant``, else
    None. Both are updated in place.
    tables/lengths: host int32 mirrors, copied to the device each step."""

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int,
                 cfg: ServingConfig, dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.pools = torch.zeros(
            (n_layers, 2, cfg.n_pages, n_kv_heads, cfg.page_size, head_dim),
            dtype=torch.int8 if cfg.kv_quant else dtype, device=device)
        self.scales = torch.zeros(
            (n_layers, 2, cfg.n_pages, n_kv_heads, cfg.page_size),
            dtype=torch.float32, device=device) if cfg.kv_quant else None
        self.tables = np.zeros((cfg.max_seqs, cfg.max_pages_per_seq), np.int32)
        self.lengths = np.zeros((cfg.max_seqs,), np.int32)
        # page n_pages-1 is the trash page: inactive slots' decode writes land
        # there so they never touch a live page
        self.trash_page = cfg.n_pages - 1
        self.free_pages = deque(range(cfg.n_pages - 1))
        self.pages_of: List[List[int]] = [[] for _ in range(cfg.max_seqs)]

    def n_free(self) -> int:
        return len(self.free_pages)

    def alloc(self, slot: int, n: int) -> List[int]:
        if n > len(self.free_pages):
            raise RuntimeError("page pool exhausted")
        if len(self.pages_of[slot]) + n > self.cfg.max_pages_per_seq:
            raise RuntimeError(f"slot {slot} exceeds max_pages_per_seq")
        got = [self.free_pages.popleft() for _ in range(n)]
        base = len(self.pages_of[slot])
        self.pages_of[slot].extend(got)
        self.tables[slot, base:base + n] = got
        return got

    def release(self, slot: int):
        self.free_pages.extend(self.pages_of[slot])
        self.pages_of[slot] = []
        self.tables[slot, :] = 0
        self.lengths[slot] = 0

    def ensure_capacity(self, slot: int):
        """Allocate the next page iff the next token write crosses into it."""
        need = self.lengths[slot] // self.cfg.page_size + 1
        if len(self.pages_of[slot]) < need:
            self.alloc(slot, 1)


@dataclasses.dataclass
class _Request:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = off
    top_p: float = 1.0         # 1 = off
    seed: int = 0
    out: List[int] = dataclasses.field(default_factory=list)


class ServingEngine:
    """``model``: "transformer" (``models.transformer`` schema, MHA) or
    "llama" (``models.llama`` schema: RoPE + GQA + SwiGLU; n_kv_heads is
    inferred from the wkv projection).

    ``keep_first_logits``: keep each request's first-token logits (fp32, on
    the host) in ``self.first_logits[req_id]``, for checking the prefill
    against a reference."""

    def __init__(self, params: Dict, *, n_heads: int,
                 cfg: ServingConfig = ServingConfig(), dtype=None,
                 model: str = "transformer", mesh=None,
                 window: Optional[int] = None,
                 draft_params: Optional[Dict] = None,
                 draft_n_heads: Optional[int] = None,
                 keep_first_logits: bool = False):
        if model not in ("transformer", "llama"):
            raise ValueError(f"unknown model family {model!r}")
        _check_ported(cfg, mesh, window, draft_params)
        bad = [b for b in cfg.prefill_buckets if b % cfg.page_size]
        if bad:
            raise ValueError(f"prefill_buckets {bad} are not multiples of "
                             f"page_size {cfg.page_size} (prefill scatters "
                             f"whole pages)")
        self.n_heads = n_heads
        self.cfg = cfg
        D = params["embed"].shape[1]
        self.head_dim = D // n_heads
        if model == "llama":
            self.n_kv_heads = _w_out_dim(params["blocks"][0]["wkv"]) // (2 * self.head_dim)
            capacity = cfg.max_pages_per_seq * cfg.page_size
            if params["rope_cos"].shape[0] < capacity:
                raise ValueError(
                    f"rope table covers {params['rope_cos'].shape[0]} positions < "
                    f"per-sequence capacity {capacity} (max_pages_per_seq * "
                    f"page_size); re-init the model with a larger max_len")
        else:
            self.n_kv_heads = n_heads
        if cfg.weight_quant:
            params = quantize_block_weights(
                params, model, mode="int4" if cfg.weight_quant == "int4" else "int8",
                group=cfg.weight_quant_group)
        self.params = params
        self._decode_fn = _decode_step if model == "transformer" else _llama_decode_step
        self._prefill_fn = _prefill_paged if model == "transformer" else _llama_prefill_paged
        self.device = params["embed"].device
        self.cache = PagedKVCache(len(params["blocks"]), self.n_kv_heads, self.head_dim,
                                  cfg, dtype or params["embed"].dtype, self.device)
        self.queue: deque[_Request] = deque()
        self.running: List[Optional[_Request]] = [None] * cfg.max_seqs
        self.finished: Dict[int, List[int]] = {}
        self.first_logits: Optional[Dict[int, torch.Tensor]] = (
            {} if keep_first_logits else None)
        self._next_id = 0
        self._tokens = np.zeros((cfg.max_seqs,), np.int32)
        # tokens a preempted request emitted before it was requeued
        self._requeued_prefix: Dict[int, List[int]] = {}
        self.stats = {"decode_steps": 0, "prefills": 0, "tokens_out": 0,
                      "requests_done": 0, "peak_pages_in_use": 0}
        self._samp = {"seed": np.zeros((cfg.max_seqs,), np.int64),
                      "temp": np.zeros((cfg.max_seqs,), np.float32),
                      "top_k": np.zeros((cfg.max_seqs,), np.int64),
                      "top_p": np.ones((cfg.max_seqs,), np.float32)}

    # -- request API -------------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int,
                    eos_id: Optional[int] = None, *,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, seed: int = 0) -> int:
        """temperature/top_k/top_p/seed: per-request sampling (defaults =
        greedy); the noise for the token at absolute index i is keyed on
        (seed, i), so preempt-and-requeue replays the same continuation."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        self._check_prompt_fits_bucket(len(prompt))
        ps = self.cfg.page_size
        need = -(-(len(prompt) + max_new_tokens) // ps)
        if need > self.cfg.max_pages_per_seq:
            raise ValueError(
                f"prompt + max_new_tokens needs {need} pages > "
                f"max_pages_per_seq {self.cfg.max_pages_per_seq}")
        if need > self.cfg.n_pages - 1:
            raise ValueError(f"request needs {need} pages > pool size "
                             f"{self.cfg.n_pages - 1}")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(_Request(rid, prompt, max_new_tokens, eos_id,
                                   float(temperature), int(top_k),
                                   float(top_p), int(seed)))
        return rid

    def _check_prompt_fits_bucket(self, n: int):
        if n > max(self.cfg.prefill_buckets):
            raise NotImplementedError(
                f"prompt of {n} tokens > largest prefill bucket "
                f"{max(self.cfg.prefill_buckets)}: chunked prefill is not ported")

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.running)

    def run(self) -> Dict[int, List[int]]:
        """Drain everything; returns {req_id: generated tokens}."""
        while self.has_work():
            self.step()
        out, self.finished = self.finished, {}
        return out

    # -- engine loop -------------------------------------------------------
    def step(self):
        self._admit()
        active = [s for s, r in enumerate(self.running) if r is not None]
        if not active:
            return
        ps = self.cfg.page_size
        # a decode step writes K/V at position lengths[s]: make sure the page
        # exists; inactive slots write to the trash page
        write_page = np.full((self.cfg.max_seqs,), self.cache.trash_page, np.int32)
        for s in active[:]:
            if self.running[s] is None:
                continue  # preempted earlier in this loop
            try:
                self.cache.ensure_capacity(s)
            except RuntimeError:
                # page pool exhausted: preempt the youngest request; it
                # re-enters the queue with prompt + generated-so-far as its
                # prompt (decoding is position-deterministic)
                others = [t for t in active if self.running[t] is not None and t != s]
                if not others:
                    self._preempt(s)
                    active.remove(s)
                    write_page[s] = self.cache.trash_page
                    continue
                victim = min(others, key=lambda t: len(self.running[t].out))
                self._preempt(victim)
                active.remove(victim)
                # the victim's page may go back out below: point it at trash
                write_page[victim] = self.cache.trash_page
                self.cache.ensure_capacity(s)  # freed pages: must succeed
            write_page[s] = self.cache.pages_of[s][self.cache.lengths[s] // ps]
        if not active:
            return
        dev = self.device
        logits = self._decode_fn(
            self.params, self.cache, torch.from_numpy(self.cache.tables).to(dev),
            torch.from_numpy(self.cache.lengths).to(dev),
            torch.from_numpy(write_page).to(dev), torch.from_numpy(self._tokens).to(dev),
            n_heads=self.n_heads, page_size=ps)
        pos = np.zeros((self.cfg.max_seqs,), np.int64)
        for s in active:
            r = self.running[s]
            pos[s] = len(r.prompt) + len(r.out)
        nxt = sample_logits_batch(self._samp["seed"], pos, logits, self._samp["temp"],
                                  self._samp["top_k"], self._samp["top_p"]).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["tokens_out"] += len(active)
        self.stats["peak_pages_in_use"] = max(
            self.stats["peak_pages_in_use"], self.cfg.n_pages - 1 - self.cache.n_free())
        for s in active:
            r = self.running[s]
            self.cache.lengths[s] += 1
            tok = int(nxt[s])
            r.out.append(tok)
            self._tokens[s] = tok
            if self._done(r, tok):
                self._finish(s)

    def _done(self, r: _Request, tok: int) -> bool:
        return len(r.out) >= r.max_new_tokens or (r.eos_id is not None and tok == r.eos_id)

    def _finish(self, slot: int):
        r = self.running[slot]
        self.stats["requests_done"] += 1
        self.finished[r.req_id] = self._requeued_prefix.pop(r.req_id, []) + r.out
        self.cache.release(slot)
        self.running[slot] = None

    def _admit(self):
        """Admit queued requests into free slots, then prefill same-bucket
        admissions in ONE batched device call per bucket."""
        pending = []  # (slot, request)
        ps = self.cfg.page_size
        while self.queue:
            slot = next((s for s, r in enumerate(self.running) if r is None), None)
            if slot is None:
                break
            r = self.queue[0]
            self._check_prompt_fits_bucket(len(r.prompt))
            n_new = -(-len(r.prompt) // ps)
            if n_new > self.cache.n_free():
                break  # backpressure: wait for pages
            self.queue.popleft()
            self.running[slot] = r
            self._samp["seed"][slot] = r.seed
            self._samp["temp"][slot] = r.temperature
            self._samp["top_k"][slot] = r.top_k
            self._samp["top_p"][slot] = r.top_p
            self.cache.alloc(slot, n_new)
            pending.append((slot, r))

        groups: Dict[int, list] = {}
        for slot, r in pending:
            bucket = next(b for b in self.cfg.prefill_buckets if b >= len(r.prompt))
            groups.setdefault(bucket, []).append((slot, r))
        for grp in groups.values():
            firsts = self._run_prefill_group([(slot, r.prompt) for slot, r in grp])
            for (slot, r), first in zip(grp, firsts):
                self.cache.lengths[slot] = len(r.prompt)
                r.out.append(first)
                self._tokens[slot] = first
                if self._done(r, first):
                    self._finish(slot)

    def _preempt(self, slot: int):
        r = self.running[slot]
        self.stats["preemptions"] = self.stats.get("preemptions", 0) + 1
        req = _Request(r.req_id, np.concatenate([r.prompt, np.asarray(r.out, np.int32)]),
                       r.max_new_tokens - len(r.out), r.eos_id, r.temperature,
                       r.top_k, r.top_p, r.seed)
        self._requeued_prefix[r.req_id] = self._requeued_prefix.get(r.req_id, []) + r.out
        self.queue.appendleft(req)
        self.cache.release(slot)
        self.running[slot] = None

    def _run_prefill_group(self, calls) -> List[int]:
        """One BATCHED device prefill for K same-bucket prompts. ``calls``:
        [(slot, prompt_tokens)]. Returns the K first tokens, sampled in one
        batched call with per-request parameters."""
        K = len(calls)
        ps = self.cfg.page_size
        longest = max(len(p) for _, p in calls)  # admission checked it fits
        bucket = next(b for b in self.cfg.prefill_buckets if b >= longest)
        n_pg = bucket // ps
        pad = np.zeros((K, bucket), np.int64)
        lens = np.zeros((K,), np.int64)
        page_vecs = np.full((K, n_pg), self.cache.trash_page, np.int64)
        for i, (slot, prompt) in enumerate(calls):
            pad[i, :len(prompt)] = prompt
            lens[i] = len(prompt)
            pages = self.cache.pages_of[slot][:-(-len(prompt) // ps)]
            page_vecs[i, :len(pages)] = pages
        dev = self.device
        logits = self._prefill_fn(self.params, self.cache, torch.from_numpy(pad).to(dev),
                                  torch.from_numpy(lens).to(dev),
                                  torch.from_numpy(page_vecs).to(dev),
                                  n_heads=self.n_heads, page_size=ps, bucket=bucket)
        self.stats["prefills"] += 1
        self.stats["tokens_out"] += K
        reqs = [self.running[slot] for slot, _ in calls]
        if self.first_logits is not None:
            for r, row in zip(reqs, logits.float().cpu()):
                self.first_logits[r.req_id] = row
        toks = sample_logits_batch([r.seed for r in reqs], [len(r.prompt) for r in reqs],
                                   logits, [r.temperature for r in reqs],
                                   [r.top_k for r in reqs], [r.top_p for r in reqs])
        return [int(t) for t in toks.cpu()]


# ---------------------------------------------------------------------------
# Weight-only quantisation of the block linears
# ---------------------------------------------------------------------------

_QUANT_KEYS = {"transformer": ("wqkv", "wo", "w1", "w2"),
               "llama": ("wq", "wkv", "wo", "w_gate", "w_up", "w_down")}


def _quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-column symmetric int8: {"q": (K, N) int8, "s": (N,) f32},
    each column rounded as ``quantize_kv`` rounds a KV row."""
    q, s = quantize_kv(w.t())
    return {"q": q.t().contiguous(), "s": s}


def quantize_block_weights(params: Dict, model: str, mode: str = "int8",
                           group: int = 64) -> Dict:
    """Quantize every block linear; norms, biases, embeddings and the
    unembedding stay full precision. mode "int8" = per-output-column scales
    ({"q", "s"} dicts); "int4" = group-wise packed nibbles ({"q4", "s4"}
    dicts, ops/gemm/int4_kernel.py). A new tree; ``params`` is unchanged."""
    if mode == "int4":
        def qfn(w):
            return quantize_int4(w, group=group)
    else:
        qfn = _quantize_weight
    out = dict(params)
    out["blocks"] = [{k: (qfn(v) if k in _QUANT_KEYS[model] else v) for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


_Q_ACTS = {None: lambda y: y, "gelu": lambda y: F.gelu(y, approximate="tanh")}


def _w_out_dim(w) -> int:
    """Output width of a weight that may be quantized (dict) or plain."""
    if isinstance(w, dict):
        return w["q4"].shape[1] if "q4" in w else w["q"].shape[1]
    return w.shape[1]


def _linear_q(h, w, b=None, act=None):
    """``linear`` that also takes a quantized weight dict. int8 ({"q", "s"}):
    one plain product on the int8 weight cast to h's dtype, then the column
    scales, as laser_tpu's ``jnp.dot`` there; int4 ({"q4", "s4"}): the
    ``w4_gemm`` kernel. A bias and the activation follow in torch."""
    if not isinstance(w, dict):
        return linear(h, w, b, act)
    if "q4" in w:
        y = gemm_w4(h, w)
    else:
        if h.dtype == torch.float32:
            pin_fp32_matmul()
        y = torch.matmul(h, w["q"].to(h.dtype)) * w["s"].to(h.dtype)
    if b is not None:
        y = y + b
    return _Q_ACTS[act](y)


# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------

def _kv_write_token(kv: PagedKVCache, li, write_page, row, k, v):
    """pools[li, 0][write_page[s], :, row[s], :] = k[s] (and v), in place,
    quantized (with its scale) when the pages are int8. Inactive slots all
    write the trash page: duplicate indices there are harmless, and they
    never touch a live page."""
    if kv.scales is not None:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        kv.scales[li, 0, write_page, :, row] = ks
        kv.scales[li, 1, write_page, :, row] = vs
    kv.pools[li, 0, write_page, :, row, :] = k
    kv.pools[li, 1, write_page, :, row, :] = v


def _kv_write_pages(kv: PagedKVCache, li, page_vec, kp, vp):
    """Prefill scatter of whole pages: kp/vp (n_pg, Hkv, ps, hd), in place,
    quantized per token when the pages are int8."""
    if kv.scales is not None:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        kv.scales[li, 0, page_vec] = ks
        kv.scales[li, 1, page_vec] = vs
    kv.pools[li, 0, page_vec] = kp
    kv.pools[li, 1, page_vec] = vp


def _kv_attend(kv: PagedKVCache, li, q, tables, att_len):
    scales = kv.scales
    return paged_attention(q, kv.pools[li, 0], kv.pools[li, 1], tables, att_len,
                           k_scale=None if scales is None else scales[li, 0],
                           v_scale=None if scales is None else scales[li, 1])


@torch.no_grad()
def _decode_step(params, kv, tables, lengths, write_page, tokens, *,
                 n_heads: int, page_size: int) -> torch.Tensor:
    """One batched decode step for all slots. Writes each slot's new K/V at
    row lengths[s] % ps of write_page[s], then attends over lengths + 1 keys
    (0 for an inactive slot). Returns (S, vocab) logits."""
    S = tokens.shape[0]
    D = params["embed"].shape[1]
    hd = D // n_heads
    lengths = lengths.int()
    att_len = torch.where(lengths > 0, lengths + 1, 0).int()
    row = (lengths % page_size).long()
    write_page = write_page.long()
    tables = tables.int()
    x = params["embed"][tokens.long()][:, None, :]  # (S, 1, D)
    for li, blk in enumerate(params["blocks"]):
        h = layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = _linear_q(h.reshape(S, D), blk["wqkv"], blk["bqkv"])
        q, k, v = (t.reshape(S, n_heads, hd).contiguous() for t in qkv.split(D, dim=-1))
        _kv_write_token(kv, li, write_page, row, k, v)
        o = _kv_attend(kv, li, q, tables, att_len)
        x = x + _linear_q(o.reshape(S, D), blk["wo"], blk["bo"]).reshape(S, 1, D)
        h = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
        f = _linear_q(h.reshape(S, D), blk["w1"], blk["b1"], "gelu")
        x = x + _linear_q(f, blk["w2"], blk["b2"]).reshape(S, 1, D)
    x = layer_norm(x, params["lnf_g"], params["lnf_b"])
    return gemm_ad(x.reshape(S, D), params["embed"], None, False, True)


@torch.no_grad()
def _prefill_paged(params, kv, prompts, lengths, page_vecs, *, n_heads: int,
                   page_size: int, bucket: int) -> torch.Tensor:
    """BATCHED flash prefill that scatters K/V into pages. prompts (K, bucket)
    zero-padded; lengths (K,) true lengths; page_vecs (K, bucket/ps) page ids
    (trash for unused). Padded positions write garbage K/V rows inside the
    last real page; causality hides them from the last real position and the
    first decode step overwrites row ``length`` before it is attended.
    Returns (K, vocab) logits at each prompt's last position."""
    D = params["embed"].shape[1]
    hd = D // n_heads
    K = prompts.shape[0]
    n_pg = bucket // page_size
    page_vec = page_vecs.reshape(-1).long()
    x = params["embed"][prompts.long()]  # (K, bucket, D)

    def pages_of(t):  # (K, H, bucket, hd) -> (K*n_pg, H, ps, hd)
        return (t.reshape(K, n_heads, n_pg, page_size, hd).transpose(1, 2)
                .reshape(K * n_pg, n_heads, page_size, hd))

    for li, blk in enumerate(params["blocks"]):
        h = layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = _linear_q(h.reshape(K * bucket, D), blk["wqkv"], blk["bqkv"])
        # row layout [q(D) | k(D) | v(D)]; heads made contiguous explicitly
        qh, kh, vh = (split_heads(t, K, bucket, n_heads) for t in qkv.split(D, dim=-1))
        _kv_write_pages(kv, li, page_vec, pages_of(kh), pages_of(vh))
        o = attention(qh, kh, vh, causal=True)
        o = o.transpose(1, 2).reshape(K * bucket, D)
        x = x + _linear_q(o, blk["wo"], blk["bo"]).reshape(K, bucket, D)
        h = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
        f = _linear_q(h.reshape(K * bucket, D), blk["w1"], blk["b1"], "gelu")
        x = x + _linear_q(f, blk["w2"], blk["b2"]).reshape(K, bucket, D)
    idx = (lengths.long() - 1).clamp(0, bucket - 1)
    last = x[torch.arange(K, device=x.device), idx]
    last = layer_norm(last, params["lnf_g"], params["lnf_b"])
    return gemm_ad(last, params["embed"], None, False, True)


# ---------------------------------------------------------------------------
# Llama-family device steps (models/llama.py schema: RoPE + GQA + SwiGLU)
# ---------------------------------------------------------------------------

def _llama_heads(params, n_heads: int):
    hd = _w_out_dim(params["blocks"][0]["wq"]) // n_heads
    return hd, _w_out_dim(params["blocks"][0]["wkv"]) // (2 * hd)


@torch.no_grad()
def _llama_decode_step(params, kv, tables, lengths, write_page, tokens, *,
                       n_heads: int, page_size: int) -> torch.Tensor:
    """``_decode_step`` for the llama schema: each slot rotates q and k at
    its own position (its current length) and attends its Hkv-head pages."""
    S = tokens.shape[0]
    D = params["embed"].shape[1]
    H = n_heads
    hd, Hkv = _llama_heads(params, H)
    lengths = lengths.int()
    att_len = torch.where(lengths > 0, lengths + 1, 0).int()
    row = (lengths % page_size).long()
    write_page = write_page.long()
    tables = tables.int()
    cos, sin = params["rope_cos"], params["rope_sin"]
    pos = torch.clamp(lengths, max=cos.shape[0] - 1)
    x = params["embed"][tokens.long()][:, None, :]  # (S, 1, D)
    for li, blk in enumerate(params["blocks"]):
        h = rms_norm(x, blk["rms1"]).reshape(S, D)
        q = _linear_q(h, blk["wq"]).reshape(S, H, hd)
        kvp = _linear_q(h, blk["wkv"]).reshape(S, 2, Hkv, hd)
        q = apply_rope_at(q, cos, sin, pos)
        k = apply_rope_at(kvp[:, 0], cos, sin, pos)
        _kv_write_token(kv, li, write_page, row, k, kvp[:, 1])
        o = _kv_attend(kv, li, q, tables, att_len)
        x = x + _linear_q(o.reshape(S, H * hd), blk["wo"]).reshape(S, 1, D)
        h = rms_norm(x, blk["rms2"]).reshape(S, D)
        f = F.silu(_linear_q(h, blk["w_gate"])) * _linear_q(h, blk["w_up"])
        x = x + _linear_q(f, blk["w_down"]).reshape(S, 1, D)
    x = rms_norm(x[:, 0, :], params["rms_f"])
    return gemm_ad(x, params["unembed"])


@torch.no_grad()
def _llama_prefill_paged(params, kv, prompts, lengths, page_vecs, *, n_heads: int,
                         page_size: int, bucket: int) -> torch.Tensor:
    """Batched llama prefill: see ``_prefill_paged`` for the batching
    contract. K and V are scattered and attended at Hkv heads (GQA flash)."""
    D = params["embed"].shape[1]
    H = n_heads
    hd, Hkv = _llama_heads(params, H)
    K = prompts.shape[0]
    n_pg = bucket // page_size
    page_vec = page_vecs.reshape(-1).long()
    cos, sin = params["rope_cos"], params["rope_sin"]
    x = params["embed"][prompts.long()]  # (K, bucket, D)

    def pages_of(t):  # (K, Hkv, bucket, hd) -> (K*n_pg, Hkv, ps, hd)
        return (t.reshape(K, Hkv, n_pg, page_size, hd).transpose(1, 2)
                .reshape(K * n_pg, Hkv, page_size, hd))

    for li, blk in enumerate(params["blocks"]):
        h = rms_norm(x, blk["rms1"]).reshape(K * bucket, D)
        q = _linear_q(h, blk["wq"]).reshape(K, bucket, H, hd).transpose(1, 2)
        kvp = _linear_q(h, blk["wkv"]).reshape(K, bucket, 2, Hkv, hd)
        q = apply_rope(q, cos, sin)                                  # (K, H, bkt, hd)
        k = apply_rope(kvp[:, :, 0].transpose(1, 2), cos, sin)       # (K, Hkv, bkt, hd)
        v = kvp[:, :, 1].transpose(1, 2).contiguous()
        _kv_write_pages(kv, li, page_vec, pages_of(k), pages_of(v))
        o = attention_gqa(q, k, v, causal=True)
        o = o.transpose(1, 2).reshape(K * bucket, H * hd)
        x = x + _linear_q(o, blk["wo"]).reshape(K, bucket, D)
        h = rms_norm(x, blk["rms2"]).reshape(K * bucket, D)
        f = F.silu(_linear_q(h, blk["w_gate"])) * _linear_q(h, blk["w_up"])
        x = x + _linear_q(f, blk["w_down"]).reshape(K, bucket, D)
    idx = (lengths.long() - 1).clamp(0, bucket - 1)
    last = rms_norm(x[torch.arange(K, device=x.device), idx], params["rms_f"])
    return gemm_ad(last, params["unembed"])
