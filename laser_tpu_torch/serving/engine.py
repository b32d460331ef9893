"""Continuous-batching serving engine over a paged KV cache (port of
laser_tpu/serving/engine.py).

Two model families: ``model="transformer"`` (``models.transformer``: MHA,
layer norms, tied embeddings) and ``model="llama"`` (``models.llama``:
RMSNorm, RoPE, GQA, SwiGLU, untied embeddings; ``n_kv_heads`` is inferred
from ``wkv``).

Host (this engine): request queue, slot and page allocation from a free
list, block tables, stop conditions, preemption. Device: one batched decode
step for every slot (fused linears, the paged-attention kernel, the K/V row
scatter) and one batched flash prefill per group of same-bucket admissions.
Unlike laser_tpu, which donates its pools to each jitted step and gets them
back, the port updates the KV pools IN PLACE.

Decode bursts (``decode_burst > 1``): ``decode_burst`` decode + sample steps
are enqueued back to back with the per-slot bookkeeping on the device
(write page, liveness, the eos / budget stop rule), so the host reads the
device once per burst instead of once per token. The host mirrors and the
sampling parameters are uploaded only when a structural change (admission,
finish, preemption, a new page) invalidates the device copies.
``pipeline_bursts``: burst n's tokens are copied to pinned host memory
behind an event and harvested only after burst n+1 is enqueued; tokens
surface one ``step()`` later, and the pending burst is landed before any
change that needs a coherent host view. Both are token-identical to
``decode_burst=1``, sampled requests included (the noise is a function of
seed and position, ``ops/sampling.py``).

Speculative decoding (``spec_gamma >= 1`` with ``draft_params``): a draft
model proposes ``spec_gamma`` tokens per round with cached decode steps into
its own pools (same pages, same tables and lengths as the target's, one
allocator), the target scores the whole window of W = gamma + 1 tokens in
one forward through the W-query paged kernel
(``ops/paged_attention.paged_window_attention``), and the round emits the
accepted prefix plus one token. ``decode_burst // (gamma + 1)`` rounds run
per burst. ``draft_weight_quant`` ("int8" / "int4") quantizes the draft's
block linears; with ``draft_params=params`` that is the quantized self-draft.
Greedy slots keep the longest prefix on which the draft's tokens equal the
target's argmax, so greedy speculation is token-identical to plain greedy
decoding up to ties between two argmax candidates, which the verify
forward (W rows) and the decode step (one row) may round differently;
sampled slots use the rejection rule (``ops/sampling.speculative_accept``),
marginally exact for plain temperature sampling (top-k / top-p raise).

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
and read by the paged kernels' int8 variants.

Not ported, each raising ``NotImplementedError``: ``prefix_cache``,
``mesh``, ``window``, and chunked prefill of a prompt longer than the
largest bucket.
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
from ..ops.paged_attention import paged_attention, paged_window_attention, quantize_kv
from ..ops.rope import apply_rope, apply_rope_at
from ..ops.sampling import (STREAM_ACCEPT, STREAM_DRAFT, gumbel, row_keys,
                            sample_logits_batch, sample_tokens, speculative_accept)


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
    decode_burst: int = 1       # decode steps per host sync
    spec_gamma: int = 0         # draft proposals per speculative round
    draft_weight_quant: "bool | str" = False
    pipeline_bursts: bool = False


def _check_ported(cfg: ServingConfig, mesh, window):
    unported = []
    if cfg.prefix_cache:
        unported.append("prefix_cache=True")
    if mesh is not None:
        unported.append("mesh (tensor-parallel serving)")
    if window is not None:
        unported.append("window (sliding-window attention)")
    if unported:
        raise NotImplementedError("not ported to laser_tpu_torch yet: "
                                  + "; ".join(unported))


def _quant_mode(q) -> str:
    return "int4" if q == "int4" else "int8"


def _vocab(params: Dict, model: str) -> int:
    return params["embed"].shape[0] if model == "transformer" else _w_out_dim(params["unembed"])


class KVPools:
    """One model's KV pages on the device, updated in place. pools:
    (L, 2, P, Hkv, ps, hd) in ``dtype``, or int8 with ``cfg.kv_quant``;
    scales: (L, 2, P, Hkv, ps) f32 with ``kv_quant``, else None."""

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int,
                 cfg: ServingConfig, dtype=torch.float32, device="cuda"):
        self.pools = torch.zeros(
            (n_layers, 2, cfg.n_pages, n_kv_heads, cfg.page_size, head_dim),
            dtype=torch.int8 if cfg.kv_quant else dtype, device=device)
        self.scales = torch.zeros(
            (n_layers, 2, cfg.n_pages, n_kv_heads, cfg.page_size),
            dtype=torch.float32, device=device) if cfg.kv_quant else None


class PagedKVCache(KVPools):
    """The target's KV pools plus the host-side allocator.

    tables/lengths: host int32 mirrors, copied to the device by the engine.
    A draft model's pools (``KVPools``) share these pages, tables and
    lengths."""

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int,
                 cfg: ServingConfig, dtype=torch.float32, device="cuda"):
        super().__init__(n_layers, n_kv_heads, head_dim, cfg, dtype, device)
        self.cfg = cfg
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


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array that later edits of the array cannot
    reach: through pinned memory and without a stream sync on the card, a
    clone on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _to_host(*ts: torch.Tensor):
    """Start copying device tensors to the host: (host tensors, the event to
    wait on before reading them, None on the CPU). The copy does not wait
    for work enqueued after it, which a plain ``.cpu()`` would."""
    if ts[0].device.type != "cuda":
        return ts, None
    host = tuple(t.to("cpu", non_blocking=True) for t in ts)  # pinned
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class ServingEngine:
    """``model``: "transformer" (``models.transformer`` schema, MHA) or
    "llama" (``models.llama`` schema: RoPE + GQA + SwiGLU; n_kv_heads is
    inferred from the wkv projection).

    ``draft_params`` / ``draft_n_heads``: the speculative draft (same family
    and vocabulary; ``draft_n_heads`` defaults to ``n_heads``), used when
    ``cfg.spec_gamma >= 1``.

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
        if cfg.decode_burst < 1:
            raise ValueError(f"decode_burst must be >= 1, got {cfg.decode_burst}")
        self.spec = draft_params is not None and cfg.spec_gamma >= 1
        if draft_params is not None and cfg.spec_gamma < 1:
            raise ValueError("draft_params given but cfg.spec_gamma < 1")
        if self.spec and mesh is not None:
            raise ValueError("speculative serving: tp mesh unsupported")
        if self.spec and window is not None:
            raise ValueError("speculative serving: sliding window unsupported")
        _check_ported(cfg, mesh, window)
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
            self._check_rope(params, "rope table")
        else:
            self.n_kv_heads = n_heads
        self.vocab = vocab = _vocab(params, model)
        if cfg.weight_quant:
            params = quantize_block_weights(params, model, mode=_quant_mode(cfg.weight_quant),
                                            group=cfg.weight_quant_group)
        self.params = params
        self._decode_fn = _decode_step if model == "transformer" else _llama_decode_step
        self._prefill_fn = _prefill_paged if model == "transformer" else _llama_prefill_paged
        self._window_fn = _window_step if model == "transformer" else _llama_window_step
        self.device = params["embed"].device
        pool_dtype = dtype or params["embed"].dtype
        self.cache = PagedKVCache(len(params["blocks"]), self.n_kv_heads, self.head_dim,
                                  cfg, pool_dtype, self.device)
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
        # device copies of the burst operands (tables, lengths, tokens,
        # remaining budget, eos, sampling parameters); None = a host change
        # invalidated them and the next burst uploads them again
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        # the enqueued but unharvested burst (pipeline_bursts)
        self._pending: Optional[dict] = None
        if self.spec:
            dv = _vocab(draft_params, model)
            if dv != vocab:
                raise ValueError(f"draft vocab {dv} != target vocab {vocab}")
            dD = draft_params["embed"].shape[1]
            dH = draft_n_heads if draft_n_heads is not None else n_heads
            if dD % dH:
                raise ValueError(f"draft d_model {dD} not divisible by draft_n_heads {dH}")
            d_hd = dD // dH
            if model == "llama":
                d_nkv = _w_out_dim(draft_params["blocks"][0]["wkv"]) // (2 * d_hd)
                self._check_rope(draft_params, "draft rope table")
            else:
                d_nkv = dH
            if cfg.draft_weight_quant:
                draft_params = quantize_block_weights(
                    draft_params, model, mode=_quant_mode(cfg.draft_weight_quant),
                    group=cfg.weight_quant_group)
            self.draft_params = draft_params
            self.draft_n_heads = dH
            self.draft_kv = KVPools(len(draft_params["blocks"]), d_nkv, d_hd, cfg,
                                    pool_dtype, self.device)
            # rounds per burst: the emitted-token budget per burst stays
            # comparable to the plain burst's decode_burst
            self.spec_rounds = max(1, cfg.decode_burst // (cfg.spec_gamma + 1))

    def _check_rope(self, params, what: str):
        capacity = self.cfg.max_pages_per_seq * self.cfg.page_size
        if params["rope_cos"].shape[0] < capacity:
            raise ValueError(
                f"{what} covers {params['rope_cos'].shape[0]} positions < "
                f"per-sequence capacity {capacity} (max_pages_per_seq * "
                f"page_size); re-init the model with a larger max_len")

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
        if self.spec and (top_k > 0 or top_p < 1.0):
            # the rejection rule is exact for plain temperature sampling;
            # filters would have to apply to both p and q at every position
            raise ValueError("speculative serving supports greedy and plain "
                             "temperature sampling only (top_k/top_p off)")
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
        if self._pending is not None and self.queue:
            # admission reuses slots the pending burst may still be
            # attributing tokens to: land it first
            self._flush_pending()
        self._admit()
        active = [s for s, r in enumerate(self.running) if r is not None]
        if not active:
            return
        if self.spec:
            if self._step_burst_spec(active):
                return
        elif self.cfg.decode_burst > 1 and self._step_burst(active):
            return
        # the single-step path edits lengths and tokens on the host per token
        self._flush_pending()
        self._dev = None
        active = [s for s in active if self.running[s] is not None]
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
        args = (torch.from_numpy(self.cache.tables).to(dev),
                torch.from_numpy(self.cache.lengths).to(dev),
                torch.from_numpy(write_page).to(dev), torch.from_numpy(self._tokens).to(dev))
        logits = self._decode_fn(self.params, self.cache, *args, n_heads=self.n_heads,
                                 page_size=ps)
        if self.spec:
            # keep the draft's pools in position: its K/V row for this step's
            # input token, at the same (page, row), so a later speculative
            # burst resumes with the draft's history complete (acceptance
            # depends on it, correctness does not)
            self._decode_fn(self.draft_params, self.draft_kv, *args,
                            n_heads=self.draft_n_heads, page_size=ps)
        pos = np.zeros((self.cfg.max_seqs,), np.int64)
        for s in active:
            r = self.running[s]
            pos[s] = len(r.prompt) + len(r.out)
        nxt = sample_logits_batch(self._samp["seed"], pos, logits, self._samp["temp"],
                                  self._samp["top_k"], self._samp["top_p"]).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["tokens_out"] += len(active)
        self._note_peak_pages()
        for s in active:
            r = self.running[s]
            self.cache.lengths[s] += 1
            tok = int(nxt[s])
            r.out.append(tok)
            self._tokens[s] = tok
            if self._done(r, tok):
                self._finish(s)

    def _note_peak_pages(self):
        self.stats["peak_pages_in_use"] = max(
            self.stats["peak_pages_in_use"], self.cfg.n_pages - 1 - self.cache.n_free())

    def _done(self, r: _Request, tok: int) -> bool:
        return len(r.out) >= r.max_new_tokens or (r.eos_id is not None and tok == r.eos_id)

    def _finish(self, slot: int):
        r = self.running[slot]
        self.stats["requests_done"] += 1
        self.finished[r.req_id] = self._requeued_prefix.pop(r.req_id, []) + r.out
        self.cache.release(slot)
        self.running[slot] = None
        self._dev = None  # the request set changed

    # -- decode bursts -----------------------------------------------------
    def _samp_flags(self) -> Tuple[bool, bool]:
        """(any slot samples, any slot filters), from the host copies; a
        finished slot's stale entry can only choose the costlier path,
        never change a token."""
        V = self.vocab
        s = self._samp
        return (bool((s["temp"] > 0).any()),
                bool((((s["top_k"] > 0) & (s["top_k"] < V)) | (s["top_p"] < 1.0)).any()))

    def _burst_prealloc(self, active, k):
        """Allocate every page a ``k``-token-per-slot burst can write, so the
        device never needs the host mid-burst. Returns (ok, any_work,
        alloc_happened); ok=False (the pool is short) lands the pending burst
        so that the caller can fall back to the single-step path, which can
        preempt."""
        ps = self.cfg.page_size
        if self._dev is None:
            # the next dispatch uploads the host mirrors, which must hold
            # every enqueued token: land the pending burst first
            self._flush_pending()
        pend = self._pending
        pend_active = set(pend["active"]) if pend is not None else set()
        pend_k = pend["k"] if pend is not None else 0
        alloc_happened = any_work = False
        for s in active:
            r = self.running[s]
            if r is None:
                continue  # finished during the flush above
            # tokens enqueued for s but not harvested: the device may be up
            # to `ahead` tokens past the host's length mirror
            ahead = min(pend_k, r.max_new_tokens - len(r.out)) if s in pend_active else 0
            kk = min(k, r.max_new_tokens - len(r.out) - ahead)
            if kk <= 0:
                continue
            any_work = True
            need = (int(self.cache.lengths[s]) + ahead + kk - 1) // ps + 1
            short = need - len(self.cache.pages_of[s])
            if short > 0:
                if short > self.cache.n_free():
                    self._flush_pending()
                    return False, any_work, alloc_happened
                self.cache.alloc(s, short)
                alloc_happened = True
        return True, any_work, alloc_happened

    def _device_carries(self, active, alloc_happened: bool) -> Dict[str, torch.Tensor]:
        """The burst operands on the device: uploaded when ``_dev`` was
        invalidated (only the tables after a new page), else the carries
        the previous burst left there."""
        d = self._dev
        dev = self.device
        if d is None:
            S = self.cfg.max_seqs
            remaining = np.zeros((S,), np.int64)
            eos = np.full((S,), -1, np.int64)
            for s in active:
                r = self.running[s]
                if r is None:
                    continue  # finished during a pending-burst flush
                remaining[s] = r.max_new_tokens - len(r.out)
                if r.eos_id is not None:
                    eos[s] = r.eos_id
            host = {"tables": self.cache.tables, "lengths": self.cache.lengths.astype(np.int64),
                    "tokens": self._tokens.astype(np.int64), "remaining": remaining,
                    "eos": eos, **self._samp}
            d = {name: _upload(a, dev) for name, a in host.items()}
        elif alloc_happened:
            d["tables"] = _upload(self.cache.tables, dev)
        self._dev = d
        return d

    def _step_burst(self, active) -> bool:
        """Decode up to ``decode_burst`` tokens per slot with one host read.
        Returns False (the caller falls back to the single-step path) when
        the pool cannot hold the whole burst."""
        k = self.cfg.decode_burst
        ok, any_work, alloc_happened = self._burst_prealloc(active, k)
        if not ok:
            return False
        if not any_work:
            # every remaining token is covered by the pending burst
            self._flush_pending()
            return True
        d = self._device_carries(active, alloc_happened)
        toks, lives = self._decode_burst(d, k)
        self.stats["decode_steps"] += k
        self.stats["decode_bursts"] = self.stats.get("decode_bursts", 0) + 1
        self._note_peak_pages()
        self._dispatched({"active": list(active), "k": k}, toks, lives)
        return True

    @torch.no_grad()
    def _decode_burst(self, d, k: int):
        """``k`` decode + sample steps enqueued back to back (laser_tpu's
        ``_decode_burst_scan``): per-slot liveness, write pages and the stop
        rule stay on the device, and nothing is read back inside the loop.
        ``remaining`` (tokens a slot may still emit; 0 = done) counts down
        and zeroes on eos, so a slot that finishes mid-burst writes the
        trash page and its later emissions are marked dead. Each live step
        samples at position lengths + 1, the single-step path's
        len(prompt) + len(out). Returns (toks, lives), each (k, S); the
        final token, length and remaining carries stay in ``d``."""
        ps, trash = self.cfg.page_size, self.cache.trash_page
        tables, eos = d["tables"], d["eos"]
        tokens, lengths, remaining = d["tokens"], d["lengths"], d["remaining"]
        sampled, filtered = self._samp_flags()
        toks, lives = [], []
        for _ in range(k):
            live = (lengths > 0) & (remaining > 0)
            l_arg = torch.where(live, lengths, 0)
            wp = torch.where(live, _table_page(tables, l_arg, ps), trash)
            logits = self._decode_fn(self.params, self.cache, tables, l_arg, wp, tokens,
                                     n_heads=self.n_heads, page_size=ps)
            nxt = sample_tokens(logits, d["seed"], lengths + 1, d["temp"], d["top_k"],
                                d["top_p"], sampled=sampled, filtered=filtered)
            nxt = torch.where(live, nxt, tokens)
            remaining = torch.where(live, remaining - 1, remaining)
            remaining = torch.where(live & (nxt == eos), 0, remaining)
            lengths = torch.where(live, lengths + 1, lengths)
            tokens = nxt
            toks.append(nxt)
            lives.append(live)
        d["tokens"], d["lengths"], d["remaining"] = tokens, lengths, remaining
        return torch.stack(toks), torch.stack(lives)

    def _dispatched(self, pend: dict, toks: torch.Tensor, lives: torch.Tensor):
        """Start copying an enqueued burst's record to the host, then harvest
        it now or, with ``pipeline_bursts``, the previous one (whose copy
        overlaps the burst just enqueued)."""
        pend["host"] = _to_host(toks, lives)
        if self.cfg.pipeline_bursts:
            prev, self._pending = self._pending, pend
            if prev is not None:
                self._harvest_burst(prev)
        else:
            self._harvest_burst(pend)

    def _flush_pending(self):
        if self._pending is not None:
            pend, self._pending = self._pending, None
            self._harvest_burst(pend)

    def _harvest_burst(self, pend):
        """Apply a burst's (toks, lives) record to the host bookkeeping."""
        (toks, lives), ev = pend["host"]
        if ev is not None:
            ev.synchronize()
        toks, lives = toks.numpy(), lives.numpy()
        k, active = pend["k"], pend["active"]
        if "spec_W" in pend:
            # a live round always emits its first window token, so live
            # rounds = the lives of window row 0; alpha = (tokens / round - 1)
            # / gamma
            W = pend["spec_W"]
            self.stats["spec_live_rounds"] = (self.stats.get("spec_live_rounds", 0)
                                              + int(lives[::W, :].sum()))
            self.stats["spec_tokens"] = self.stats.get("spec_tokens", 0) + int(lives.sum())
        for t in range(k):
            for s in active:
                if not lives[t, s] or self.running[s] is None:
                    continue
                r = self.running[s]
                tok = int(toks[t, s])
                r.out.append(tok)
                self.cache.lengths[s] += 1
                self._tokens[s] = tok
                self.stats["tokens_out"] += 1
                if self._done(r, tok):
                    self._finish(s)

    # -- speculative decoding ----------------------------------------------
    def _step_burst_spec(self, active) -> bool:
        """``spec_rounds`` propose/verify rounds with one host read. A round
        emits 1..gamma+1 tokens per live slot, so pages are allocated for
        rounds * (gamma + 1) tokens, like a plain burst of that depth (the
        writes are masked to the emission budget, so no page past it is
        needed); the harvest reads the rounds' (W, S) emissions as a
        (rounds * W, S) record."""
        W = self.cfg.spec_gamma + 1
        R = self.spec_rounds
        ok, any_work, alloc_happened = self._burst_prealloc(active, R * W)
        if not ok:
            return False
        if not any_work:
            self._flush_pending()
            return True
        d = self._device_carries(active, alloc_happened)
        toks, lives = self._spec_burst(d, R)
        self.stats["spec_bursts"] = self.stats.get("spec_bursts", 0) + 1
        self.stats["decode_steps"] += R * W
        self._note_peak_pages()
        self._dispatched({"active": list(active), "k": R * W, "spec_W": W}, toks, lives)
        return True

    @torch.no_grad()
    def _spec_burst(self, d, rounds: int):
        """``rounds`` speculative rounds enqueued back to back (laser_tpu's
        ``_spec_burst_scan``). Per round and live slot: gamma draft decode
        steps propose the tokens at positions l+1..l+gamma, one more writes
        the last proposal's draft K/V, the target scores the window of W
        tokens in one verify forward, and the accepted prefix plus one token
        is emitted, cut at eos and at the remaining budget.

        Rollback is free on a paged cache: a rejected position's K/V rows, in
        both pools, are overwritten when the position is filled again, so a
        slot's length is its only rollback state. Writes go to the table
        page only while i < remaining (emittable), else to the trash page,
        so a query at an emitted index never reads an unwritten row."""
        S = self.cfg.max_seqs
        gamma = self.cfg.spec_gamma
        W = gamma + 1
        ps, trash = self.cfg.page_size, self.cache.trash_page
        tables, eos, seeds, temps = d["tables"], d["eos"], d["seed"], d["temp"]
        tokens, lengths, remaining = d["tokens"], d["lengths"], d["remaining"]
        sampled = self._samp_flags()[0]
        inv_t = torch.where(temps > 0, 1.0 / temps.clamp_min(1e-8), 1.0)
        idx = torch.arange(W, device=tokens.device)
        emits, masks = [], []
        for _ in range(rounds):
            live = (lengths > 0) & (remaining > 0)
            l_arg = torch.where(live, lengths, 0)
            wpos = l_arg[:, None] + idx[None, :]                           # (S, W)
            wp = torch.where(live[:, None] & (idx[None, :] < remaining[:, None]),
                             _table_page(tables, wpos, ps), trash)
            # -- draft: gamma proposals, then the last proposal's K/V ----
            wtok, qs, tok = [tokens], [], tokens
            for i in range(W):
                dlog = self._decode_fn(self.draft_params, self.draft_kv, tables,
                                       torch.where(live, l_arg + i, 0), wp[:, i], tok,
                                       n_heads=self.draft_n_heads, page_size=ps)
                if i == gamma:
                    break
                tok = torch.argmax(dlog, dim=-1)
                if sampled:
                    lg = dlog.float() * inv_t[:, None]
                    keys = row_keys(seeds, l_arg + i + 1, STREAM_DRAFT)
                    drawn = torch.argmax(lg + gumbel(keys, lg.shape[-1]), dim=-1)
                    tok = torch.where(temps > 0, drawn, tok)
                    qs.append(torch.softmax(lg, dim=-1))
                wtok.append(tok)
            wtok = torch.stack(wtok, 1)                                    # (S, W)
            # -- target: one W-query verify forward ------------------------
            tlog = self._window_fn(self.params, self.cache, tables, l_arg, live, wp,
                                   wpos % ps, wtok, n_heads=self.n_heads, page_size=ps)
            # -- acceptance ----------------------------------------------
            prop = wtok[:, 1:]                                             # (S, gamma)
            gre = torch.argmax(tlog, dim=-1)                               # (S, W)
            match = torch.cat([prop == gre[:, :gamma], torch.zeros_like(live[:, None])], 1)
            n_acc = torch.argmin(match.int(), dim=1)  # the first mismatch, or gamma
            nxt = gre.gather(1, n_acc[:, None]).squeeze(1)
            if sampled:
                p = torch.softmax(tlog.float() * inv_t[:, None, None], dim=-1)
                n_s, nxt_s = speculative_accept(p, torch.stack(qs, 1), prop,
                                                row_keys(seeds, l_arg, STREAM_ACCEPT))
                on = temps > 0
                n_acc = torch.where(on, n_s, n_acc)
                nxt = torch.where(on, nxt_s, nxt)
            # -- emission: accepted prefix + one, cut by eos and budget ---
            emit = torch.where(idx[None, :] == n_acc[:, None], nxt[:, None],
                               torch.cat([prop, torch.zeros_like(prop[:, :1])], 1))
            n_em = n_acc + 1
            is_eos = (emit == eos[:, None]) & (idx[None, :] < n_em[:, None])
            first_eos = torch.where(is_eos, idx[None, :], W).amin(dim=1)
            n_em = torch.minimum(torch.minimum(n_em, first_eos + 1), remaining)
            n_em = torch.where(live, n_em, 0)
            mask = idx[None, :] < n_em[:, None]
            eos_hit = (is_eos & mask).any(dim=1)
            lengths = lengths + n_em
            remaining = torch.where(live, remaining - n_em, remaining)
            remaining = torch.where(eos_hit, 0, remaining)
            last = emit.gather(1, (n_em - 1).clamp(min=0)[:, None]).squeeze(1)
            tokens = torch.where(n_em > 0, last, tokens)
            emits.append(emit)
            masks.append(mask)
        d["tokens"], d["lengths"], d["remaining"] = tokens, lengths, remaining
        # (rounds, S, W) -> time-major (rounds * W, S): the harvest's record
        toks = torch.stack(emits).transpose(1, 2).reshape(rounds * W, S)
        lives = torch.stack(masks).transpose(1, 2).reshape(rounds * W, S)
        return toks, lives

    # -- admission ---------------------------------------------------------
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
        if pending:
            self._dev = None  # slots, sampling parameters, tables and lengths changed

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
        self._dev = None  # the request set changed

    def _run_prefill_group(self, calls) -> List[int]:
        """One BATCHED device prefill for K same-bucket prompts (and the
        draft's prefill of the same pages, its logits discarded). ``calls``:
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
        args = (torch.from_numpy(pad).to(dev), torch.from_numpy(lens).to(dev),
                torch.from_numpy(page_vecs).to(dev))
        logits = self._prefill_fn(self.params, self.cache, *args, n_heads=self.n_heads,
                                  page_size=ps, bucket=bucket)
        if self.spec:
            self._prefill_fn(self.draft_params, self.draft_kv, *args,
                             n_heads=self.draft_n_heads, page_size=ps, bucket=bucket)
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


def _table_page(tables: torch.Tensor, positions: torch.Tensor, page_size: int) -> torch.Tensor:
    """tables[s, positions[s, ...] // page_size], the column clamped to the
    table: positions past the emission budget reach column max_pages (an
    out-of-range gather would be a device assert); the callers send those
    writes to the trash page."""
    col = (positions // page_size).clamp(max=tables.shape[1] - 1)
    return tables.gather(1, col.reshape(col.shape[0], -1)).reshape(col.shape)


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

def _kv_write_token(kv: KVPools, li, write_page, row, k, v):
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


def _kv_write_pages(kv: KVPools, li, page_vec, kp, vp):
    """Prefill scatter of whole pages: kp/vp (n_pg, Hkv, ps, hd), in place,
    quantized per token when the pages are int8."""
    if kv.scales is not None:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        kv.scales[li, 0, page_vec] = ks
        kv.scales[li, 1, page_vec] = vs
    kv.pools[li, 0, page_vec] = kp
    kv.pools[li, 1, page_vec] = vp


def _kv_attend(kv: KVPools, li, q, tables, att_len):
    scales = kv.scales
    return paged_attention(q, kv.pools[li, 0], kv.pools[li, 1], tables, att_len,
                           k_scale=None if scales is None else scales[li, 0],
                           v_scale=None if scales is None else scales[li, 1])


def _kv_window_attend(kv: KVPools, li, q, tables, att_len):
    scales = kv.scales
    return paged_window_attention(q, kv.pools[li, 0], kv.pools[li, 1], tables, att_len,
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


# ---------------------------------------------------------------------------
# Speculative verify steps: W window tokens per slot in one forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def _window_step(params, kv, tables, base, live, wp, wrow, wtok, *, n_heads: int,
                 page_size: int) -> torch.Tensor:
    """The verify forward, transformer family. wtok (S, W) holds the tokens
    at positions base .. base+W-1; their K/V rows are scattered to
    (wp, wrow) per position (the trash page past the emission budget), then
    ONE W-query paged attention per layer scores all W positions. Returns
    (S, W, vocab) logits; window index w predicts position base+w+1, the
    contract of the dense ``window_step`` (W = 1 is the decode step)."""
    S, W = wtok.shape
    D = params["embed"].shape[1]
    H = n_heads
    hd = D // H
    att_len = torch.where(live, base + W, 0).int()
    wp, wrow = wp.reshape(-1).long(), wrow.reshape(-1).long()
    tables = tables.int()
    x = params["embed"][wtok.long()]                                   # (S, W, D)
    for li, blk in enumerate(params["blocks"]):
        h = layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = _linear_q(h.reshape(S * W, D), blk["wqkv"], blk["bqkv"])
        q, k, v = (t.reshape(S * W, H, hd) for t in qkv.split(D, dim=-1))
        _kv_write_token(kv, li, wp, wrow, k, v)
        o = _kv_window_attend(kv, li, q.reshape(S, W, H, hd).contiguous(), tables, att_len)
        x = x + _linear_q(o.reshape(S * W, D), blk["wo"], blk["bo"]).reshape(S, W, D)
        h = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
        f = _linear_q(h.reshape(S * W, D), blk["w1"], blk["b1"], "gelu")
        x = x + _linear_q(f, blk["w2"], blk["b2"]).reshape(S, W, D)
    x = layer_norm(x, params["lnf_g"], params["lnf_b"])
    return gemm_ad(x.reshape(S * W, D), params["embed"], None, False, True).reshape(S, W, -1)


@torch.no_grad()
def _llama_window_step(params, kv, tables, base, live, wp, wrow, wtok, *, n_heads: int,
                       page_size: int) -> torch.Tensor:
    """The verify forward, llama family: the paged twin of the dense
    ``llama_window_step``; see ``_window_step``. RoPE positions are clamped
    to the table, as in the decode step: a window past the emission budget
    can reach past a slot's capacity, and those rows go to the trash page
    and are never emitted."""
    S, W = wtok.shape
    D = params["embed"].shape[1]
    H = n_heads
    hd, Hkv = _llama_heads(params, H)
    att_len = torch.where(live, base + W, 0).int()
    wp, wrow = wp.reshape(-1).long(), wrow.reshape(-1).long()
    tables = tables.int()
    cos, sin = params["rope_cos"], params["rope_sin"]
    arange = torch.arange(W, device=base.device)
    pos = torch.clamp(base[:, None] + arange[None, :], max=cos.shape[0] - 1).reshape(-1)
    x = params["embed"][wtok.long()]                                   # (S, W, D)
    for li, blk in enumerate(params["blocks"]):
        h = rms_norm(x, blk["rms1"]).reshape(S * W, D)
        q = _linear_q(h, blk["wq"]).reshape(S * W, H, hd)
        kvp = _linear_q(h, blk["wkv"]).reshape(S * W, 2, Hkv, hd)
        q = apply_rope_at(q, cos, sin, pos).reshape(S, W, H, hd)
        k = apply_rope_at(kvp[:, 0], cos, sin, pos)
        _kv_write_token(kv, li, wp, wrow, k, kvp[:, 1])
        o = _kv_window_attend(kv, li, q, tables, att_len)
        x = x + _linear_q(o.reshape(S * W, H * hd), blk["wo"]).reshape(S, W, D)
        h = rms_norm(x, blk["rms2"]).reshape(S * W, D)
        f = F.silu(_linear_q(h, blk["w_gate"])) * _linear_q(h, blk["w_up"])
        x = x + _linear_q(f, blk["w_down"]).reshape(S, W, D)
    x = rms_norm(x, params["rms_f"])
    return gemm_ad(x.reshape(S * W, D), params["unembed"]).reshape(S, W, -1)
