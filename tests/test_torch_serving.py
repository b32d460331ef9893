"""The port's transformer and serving engine against laser_tpu's, on
laser_tpu-made params moved across with ``params_from_numpy``: the
transformer family, and the llama family unquantized, with int8 and int4
weights and with int8 KV pages.

Tolerances: prefill / decode_step logits within 1e-4 absolute (f32, logits
O(1)); generated greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laser_tpu.config as jconfig
from laser_tpu.models import llama as jllama
from laser_tpu.models import transformer as jtf
from laser_tpu.serving import ServingConfig as JServingConfig
from laser_tpu.serving import ServingEngine as JServingEngine
from laser_tpu_torch.convert import params_from_numpy
from laser_tpu_torch.models import transformer as tf
from laser_tpu_torch.serving import ServingConfig, ServingEngine

N_HEADS = 2
VOCAB = 97


@pytest.fixture(scope="module")
def models():
    jparams = jtf.init_transformer(jax.random.PRNGKey(7), n_layers=2, d_model=128,
                                   n_heads=N_HEADS, d_ff=256, vocab=VOCAB)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def test_prefill_and_decode_step_logits(models):
    jparams, params = models
    rng = np.random.RandomState(40)
    prompt = rng.randint(0, VOCAB, (2, 11)).astype(np.int32)
    cap = 16
    jcache = jtf.init_decode_cache(2, 2, N_HEADS, 64, cap)
    jlog, jcache = jtf.prefill(jparams, jnp.asarray(prompt), jcache, n_heads=N_HEADS)
    cache = tf.init_decode_cache(2, 2, N_HEADS, 64, cap, device="cpu")
    log = tf.prefill(params, torch.from_numpy(prompt).long(), cache, n_heads=N_HEADS)
    assert np.abs(log.numpy() - np.asarray(jlog)).max() <= 1e-4
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=1e-4)

    tok = np.array(jnp.argmax(jlog, -1), np.int32)
    jlog2, _ = jtf.decode_step(jparams, jcache, jnp.asarray(tok), jnp.int32(11),
                               n_heads=N_HEADS)
    log2 = tf.decode_step(params, cache, torch.from_numpy(tok).long(), 11, n_heads=N_HEADS)
    assert np.abs(log2.numpy() - np.asarray(jlog2)).max() <= 1e-4


def test_forward_logits(models):
    jparams, params = models
    toks = np.random.RandomState(41).randint(0, VOCAB, (2, 20)).astype(np.int32)
    want = np.asarray(jtf.transformer_forward(jparams, jnp.asarray(toks), n_heads=N_HEADS))
    got = tf.transformer_forward(params, torch.from_numpy(toks).long(), n_heads=N_HEADS)
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_engine_tokens_match_laser_tpu_engine(models):
    """3 requests through 2 slots: the port's engine, laser_tpu's engine and
    the port's dense greedy_decode emit identical tokens."""
    jparams, params = models
    rng = np.random.RandomState(42)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32) for n in (5, 20, 13)]
    new = [6, 4, 5]
    kw = dict(page_size=16, n_pages=16, max_seqs=2, max_pages_per_seq=3,
              prefill_buckets=(16, 32))
    jeng = JServingEngine(jparams, n_heads=N_HEADS, cfg=JServingConfig(**kw))
    eng = ServingEngine(params, n_heads=N_HEADS, cfg=ServingConfig(**kw),
                        keep_first_logits=True)
    jids = [jeng.add_request(p, m) for p, m in zip(prompts, new)]
    ids = [eng.add_request(p, m) for p, m in zip(prompts, new)]
    jout, out = jeng.run(), eng.run()
    for p, m, jid, rid in zip(prompts, new, jids, ids):
        dense = tf.greedy_decode(params, torch.from_numpy(p[None]).long(), n_heads=N_HEADS,
                                 max_new_tokens=m)[0, len(p):].tolist()
        assert out[rid] == jout[jid] == dense
        # the paged prefill's first-token logits are laser_tpu's dense forward's
        want = np.asarray(jtf.transformer_forward(jparams, jnp.asarray(p[None]),
                                                  n_heads=N_HEADS))[0, -1]
        assert np.abs(eng.first_logits[rid].numpy() - want).max() <= 1e-4
    assert eng.cache.n_free() == 15  # every page returned


def test_preemption_under_page_pressure(models):
    _, params = models
    rng = np.random.RandomState(43)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32) for n in (14, 15)]
    cfg = ServingConfig(page_size=16, n_pages=4, max_seqs=2, max_pages_per_seq=3,
                        prefill_buckets=(16, 32))
    eng = ServingEngine(params, n_heads=N_HEADS, cfg=cfg)
    ids = [eng.add_request(p, 10) for p in prompts]
    out = eng.run()
    assert eng.stats.get("preemptions", 0) >= 1
    for p, rid in zip(prompts, ids):
        dense = tf.greedy_decode(params, torch.from_numpy(p[None]).long(), n_heads=N_HEADS,
                                 max_new_tokens=10)[0, len(p):].tolist()
        assert out[rid] == dense


def test_sampled_request_is_deterministic(models):
    _, params = models
    cfg = ServingConfig(page_size=16, n_pages=16, max_seqs=2, max_pages_per_seq=3,
                        prefill_buckets=(16, 32))
    prompt = np.arange(9, dtype=np.int32)
    runs = []
    for _ in range(2):
        eng = ServingEngine(params, n_heads=N_HEADS, cfg=cfg)
        rid = eng.add_request(prompt, 8, temperature=0.9, top_k=20, top_p=0.9, seed=3)
        runs.append(eng.run()[rid])
    assert runs[0] == runs[1] and len(runs[0]) == 8
    assert all(0 <= t < VOCAB for t in runs[0])


def test_quantized_transformer_engine_matches_laser_tpu_engine(models):
    """The transformer family through the same quantised linears: int4
    weights (group 16) and int8 KV pages together, token-identical to
    laser_tpu's engine (int8 pages at its f32 tier)."""
    jparams, params = models
    rng = np.random.RandomState(45)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32) for n in (5, 9, 14)]
    kw = dict(page_size=16, n_pages=16, max_seqs=2, max_pages_per_seq=3,
              prefill_buckets=(16, 32), weight_quant="int4", weight_quant_group=16,
              kv_quant=True)
    old = jconfig.get_config().paged_quant_mode
    try:
        jconfig.set_config(paged_quant_mode="base")
        jeng = JServingEngine(jparams, n_heads=N_HEADS, cfg=JServingConfig(**kw))
        jids = [jeng.add_request(p, 5) for p in prompts]
        jout = jeng.run()
    finally:
        jconfig.set_config(paged_quant_mode=old)
    eng = ServingEngine(params, n_heads=N_HEADS, cfg=ServingConfig(**kw))
    ids = [eng.add_request(p, 5) for p in prompts]
    out = eng.run()
    assert [out[i] for i in ids] == [[int(t) for t in jout[j]] for j in jids]
    assert eng.cache.scales is not None and eng.params["blocks"][0]["wqkv"].keys() == {"q4", "s4"}


@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True), dict(spec_gamma=2), dict(pipeline_bursts=True),
    dict(decode_burst=4), dict(draft_weight_quant="int8"),
], ids=lambda kw: next(iter(kw)))
def test_unported_config_raises(models, kw):
    """``prefix_cache`` is not ported and raises. The other options are
    served now and give the default engine's tokens: decode bursts and
    pipelining run; ``spec_gamma`` and ``draft_weight_quant`` without a
    draft are accepted and ignored, as laser_tpu ignores them."""
    _, params = models
    cfg = dict(page_size=16, n_pages=16, max_seqs=2, max_pages_per_seq=3,
               prefill_buckets=(16, 32))
    if "prefix_cache" in kw:
        with pytest.raises(NotImplementedError):
            ServingEngine(params, n_heads=N_HEADS, cfg=ServingConfig(**cfg, **kw))
        return
    prompts = [np.random.RandomState(46).randint(0, VOCAB, n).astype(np.int32)
               for n in (5, 20, 13)]
    outs = []
    for extra in ({}, kw):
        eng = ServingEngine(params, n_heads=N_HEADS, cfg=ServingConfig(**cfg, **extra))
        ids = [eng.add_request(p, 9) for p in prompts]
        out = eng.run()
        outs.append([out[i] for i in ids])
        assert not eng.spec
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(window=8), dict(draft_params={})],
                         ids=lambda kw: next(iter(kw)))
def test_unported_engine_arguments_raise(models, kw):
    """``mesh`` and ``window`` are not ported; draft params without
    ``spec_gamma >= 1`` are an error, as in laser_tpu."""
    _, params = models
    with pytest.raises(ValueError if "draft_params" in kw else NotImplementedError):
        ServingEngine(params, n_heads=N_HEADS, cfg=ServingConfig(page_size=16), **kw)


def test_chunked_prefill_raises(models):
    _, params = models
    eng = ServingEngine(params, n_heads=N_HEADS,
                        cfg=ServingConfig(page_size=16, prefill_buckets=(16, 32)))
    with pytest.raises(NotImplementedError):
        eng.add_request(np.zeros(40, np.int32), 4)


# ---------------------------------------------------------------------------
# The llama family: 2 layers, d_model 128, 8 heads over 2 kv heads
# ---------------------------------------------------------------------------

LLAMA_HEADS, LLAMA_KV_HEADS = 8, 2
LLAMA_CFG = dict(page_size=16, n_pages=32, max_seqs=2, max_pages_per_seq=6,
                 prefill_buckets=(16, 32, 64))
# prompts of 7, 12 and 21 tokens: two buckets, a decode across a page
# boundary, three requests through two slots
LLAMA_PROMPTS, LLAMA_NEW = (7, 12, 21), 5
LLAMA_CASES = {"unquantized": {}, "int8": dict(weight_quant="int8"),
               "int4": dict(weight_quant="int4", weight_quant_group=16),
               "kv_quant": dict(kv_quant=True)}


@pytest.fixture(scope="module")
def llama_models():
    jparams = jllama.init_llama(jax.random.PRNGKey(3), n_layers=2, d_model=128,
                                n_heads=LLAMA_HEADS, n_kv_heads=LLAMA_KV_HEADS, d_ff=256,
                                vocab=VOCAB, max_len=256)
    rng = np.random.RandomState(44)
    prompts = [rng.randint(0, VOCAB, n).astype(np.int32) for n in LLAMA_PROMPTS]
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"), prompts


def _jax_llama_tokens(jparams, prompts, kw):
    """laser_tpu's engine on one config; int8 KV pages at its f32 tier."""
    old = jconfig.get_config().paged_quant_mode
    try:
        jconfig.set_config(paged_quant_mode="base")
        eng = JServingEngine(jparams, n_heads=LLAMA_HEADS, model="llama",
                             cfg=JServingConfig(**LLAMA_CFG, **kw))
        ids = [eng.add_request(p, LLAMA_NEW) for p in prompts]
        out = eng.run()
    finally:
        jconfig.set_config(paged_quant_mode=old)
    return [[int(t) for t in out[i]] for i in ids]


@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_llama_engine_tokens_match_laser_tpu_engine(llama_models, case):
    jparams, params, prompts = llama_models
    kw = LLAMA_CASES[case]
    want = _jax_llama_tokens(jparams, prompts, kw)
    eng = ServingEngine(params, n_heads=LLAMA_HEADS, model="llama",
                        cfg=ServingConfig(**LLAMA_CFG, **kw))
    assert eng.n_kv_heads == LLAMA_KV_HEADS
    assert eng.cache.pools.dtype == (torch.int8 if kw.get("kv_quant") else torch.float32)
    ids = [eng.add_request(p, LLAMA_NEW) for p in prompts]
    out = eng.run()
    assert [out[i] for i in ids] == want
    assert eng.cache.n_free() == LLAMA_CFG["n_pages"] - 1
    if not kw:  # and both engines are the dense llama_generate's
        from laser_tpu_torch.models.llama import llama_generate

        for p, toks in zip(prompts, want):
            dense = llama_generate(params, torch.from_numpy(p[None]), n_heads=LLAMA_HEADS,
                                   n_kv_heads=LLAMA_KV_HEADS, max_new_tokens=LLAMA_NEW)
            assert dense[0, len(p):].tolist() == toks


def test_llama_engine_checks_the_rope_table(llama_models):
    _, params, _ = llama_models
    with pytest.raises(ValueError, match="rope table"):
        ServingEngine(params, n_heads=LLAMA_HEADS, model="llama",
                      cfg=ServingConfig(page_size=16, max_pages_per_seq=17))


def test_quantized_weights_keep_the_tree(llama_models):
    """quantize_block_weights leaves norms, embeddings and the caller's tree
    alone; params_from_numpy keeps int8 leaves int8 and scales f32."""
    from laser_tpu.serving.engine import quantize_block_weights as jquantize
    from laser_tpu_torch.serving.engine import quantize_block_weights

    jparams, params, _ = llama_models
    q = quantize_block_weights(params, "llama", mode="int4", group=16)
    assert set(q["blocks"][0]["w_up"]) == {"q4", "s4"}
    assert q["blocks"][0]["rms1"] is params["blocks"][0]["rms1"]
    assert q["unembed"] is params["unembed"] and torch.is_tensor(params["blocks"][0]["w_up"])
    moved = params_from_numpy(jax.tree.map(np.asarray, jquantize(jparams, "llama", "int8")),
                              device="cpu", dtype=torch.bfloat16)
    assert moved["blocks"][0]["wq"]["q"].dtype == torch.int8
    assert moved["blocks"][0]["wq"]["s"].dtype == torch.float32
    assert moved["blocks"][0]["rms1"].dtype == torch.bfloat16
