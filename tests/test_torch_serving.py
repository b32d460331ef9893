"""The port's transformer and serving engine against laser_tpu's, on
laser_tpu-made params moved across with ``params_from_numpy``.

Tolerances: prefill / decode_step logits within 1e-4 absolute (f32, logits
O(1)); generated greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True), dict(kv_quant=True), dict(weight_quant="int8"),
    dict(weight_quant="int4"), dict(spec_gamma=2), dict(pipeline_bursts=True),
    dict(decode_burst=4), dict(draft_weight_quant="int8"),
], ids=lambda kw: next(iter(kw)))
def test_unported_config_raises(models, kw):
    _, params = models
    with pytest.raises(NotImplementedError):
        ServingEngine(params, n_heads=N_HEADS, cfg=ServingConfig(page_size=16, **kw))


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(window=8), dict(model="llama"),
                                dict(draft_params={})], ids=lambda kw: next(iter(kw)))
def test_unported_engine_arguments_raise(models, kw):
    _, params = models
    with pytest.raises(NotImplementedError):
        ServingEngine(params, n_heads=N_HEADS, cfg=ServingConfig(page_size=16), **kw)


def test_chunked_prefill_raises(models):
    _, params = models
    eng = ServingEngine(params, n_heads=N_HEADS,
                        cfg=ServingConfig(page_size=16, prefill_buckets=(16, 32)))
    with pytest.raises(NotImplementedError):
        eng.add_request(np.zeros(40, np.int32), 4)
