"""The port's llama family against laser_tpu's: RoPE, grouped-query flash
attention, the forward and greedy generation, on laser_tpu-made params moved
across with ``params_from_numpy`` and numpy inputs, in f32.

Each output is held against its own max |reference|: RoPE tables and
rotations within 1e-6, ``attention_gqa`` within 2e-5 (laser_tpu's kernel in
interpret mode), ``llama_forward`` logits within 1e-4; greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.models import llama as jllama
from laser_tpu.ops import rope as jrope
from laser_tpu.ops.attention import attention_gqa as jattention_gqa
from laser_tpu_torch.convert import params_from_numpy
from laser_tpu_torch.models import llama
from laser_tpu_torch.ops import rope
from laser_tpu_torch.ops.attention import FLASH, attention_gqa, attention_gqa_reference

N_HEADS, N_KV_HEADS, VOCAB = 8, 2, 97


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def models():
    jparams = jllama.init_llama(jax.random.PRNGKey(3), n_layers=2, d_model=128,
                                n_heads=N_HEADS, n_kv_heads=N_KV_HEADS, d_ff=256,
                                vocab=VOCAB, max_len=256)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("base", [10000.0, 500000.0])
def test_rope_tables_and_rotations(base):
    jc, js = jrope.rope_tables(64, 32, base=base)
    c, s = rope.rope_tables(64, 32, base=base, device="cpu")
    assert _rel(c.numpy(), jc) <= 1e-6 and _rel(s.numpy(), js) <= 1e-6
    x = np.random.RandomState(50).randn(2, 3, 9, 32).astype(np.float32)
    want = jrope.apply_rope(jnp.asarray(x), jc, js, position_offset=5)
    got = rope.apply_rope(torch.from_numpy(x), c, s, position_offset=5)
    assert _rel(got.numpy(), want) <= 1e-6
    pos = np.array([0, 7, 63], np.int32)
    xr = x[:, 0, :3].transpose(1, 0, 2).copy()  # (3, 2, 32)
    want = jrope.apply_rope_at(jnp.asarray(xr), jc, js, jnp.asarray(pos))
    got = rope.apply_rope_at(torch.from_numpy(xr), c, s, torch.from_numpy(pos))
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("Hkv,causal", [(2, True), (1, False), (4, True)])
def test_attention_gqa(Hkv, causal):
    rng = np.random.RandomState(51)
    q = rng.randn(2, 8, 37, 32).astype(np.float32)
    k, v = (rng.randn(2, Hkv, 37, 32).astype(np.float32) for _ in range(2))
    want = np.asarray(jattention_gqa(q, k, v, causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = FLASH.plain_calls
    got = attention_gqa(tq, tk, tv, causal=causal)
    assert FLASH.plain_calls == before + 1  # a CPU tensor takes the plain version
    assert _rel(got.numpy(), want) <= 2e-5
    torch.testing.assert_close(got, attention_gqa_reference(tq, tk, tv, causal=causal),
                               rtol=0, atol=0)


def test_attention_gqa_rejects_bad_shapes_and_window():
    q, k = torch.zeros(1, 6, 8, 16), torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        attention_gqa(q, k, k)
    with pytest.raises(NotImplementedError):
        attention_gqa(torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16),
                      torch.zeros(1, 2, 8, 16), causal=True, window=4)


def test_llama_forward_logits(models):
    jparams, params = models
    toks = np.random.RandomState(52).randint(0, VOCAB, (2, 21)).astype(np.int32)
    want = np.asarray(jllama.llama_forward(jparams, jnp.asarray(toks), n_heads=N_HEADS,
                                           n_kv_heads=N_KV_HEADS))
    got = llama.llama_forward(params, torch.from_numpy(toks), n_heads=N_HEADS,
                              n_kv_heads=N_KV_HEADS)
    assert _rel(got.numpy(), want) <= 1e-4


def test_llama_generate_greedy_tokens(models):
    """Two prompts in one batch: laser_tpu's llama_generate, the port's, and
    the port's through its plain versions emit the same greedy tokens; the
    prefill's cache equals laser_tpu's."""
    jparams, params = models
    prompt = np.random.RandomState(53).randint(0, VOCAB, (2, 13)).astype(np.int32)
    want = np.asarray(jllama.llama_generate(
        jparams, jnp.asarray(prompt), jax.random.PRNGKey(0), n_heads=N_HEADS,
        n_kv_heads=N_KV_HEADS, max_new_tokens=6, temperature=0.0))
    for plain in (False, True):
        got = llama.llama_generate(params, torch.from_numpy(prompt), n_heads=N_HEADS,
                                   n_kv_heads=N_KV_HEADS, max_new_tokens=6, plain=plain)
        np.testing.assert_array_equal(got.numpy(), want)
    jcache = jllama.init_llama_cache(jparams, 2, 16, n_heads=N_HEADS, n_kv_heads=N_KV_HEADS)
    _, jcache = jllama.llama_prefill(jparams, jnp.asarray(prompt), jcache, n_heads=N_HEADS,
                                     n_kv_heads=N_KV_HEADS)
    cache = llama.init_llama_cache(params, 2, 16, n_heads=N_HEADS, n_kv_heads=N_KV_HEADS,
                                   device="cpu")
    llama.llama_prefill(params, torch.from_numpy(prompt), cache, n_heads=N_HEADS,
                        n_kv_heads=N_KV_HEADS)
    assert _rel(cache.numpy(), jcache) <= 1e-5


def test_init_llama_schema_matches_laser_tpu(models):
    jparams, _ = models
    params = llama.init_llama(0, n_layers=2, d_model=128, n_heads=N_HEADS,
                              n_kv_heads=N_KV_HEADS, d_ff=256, vocab=VOCAB, max_len=256,
                              device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    for path, leaf in flat:
        t = params
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    np.testing.assert_array_equal(params["rope_cos"].numpy(), np.asarray(jparams["rope_cos"]))
    # the same scales: std of each matrix within 5% of laser_tpu's
    for name in ("wq", "wkv", "w_down"):
        a, b = params["blocks"][0][name].std().item(), float(np.std(jparams["blocks"][0][name]))
        assert abs(a - b) <= 0.05 * b


def test_unported_options_raise(models):
    _, params = models
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        llama.llama_forward(params, toks, n_heads=N_HEADS, n_kv_heads=N_KV_HEADS, window=2)
    with pytest.raises(NotImplementedError):
        llama.llama_hidden(params, toks, n_heads=N_HEADS, n_kv_heads=N_KV_HEADS, window=2)
    # remat is ported (tests/test_torch_llama_train.py): the same hidden states
    kw = dict(n_heads=N_HEADS, n_kv_heads=N_KV_HEADS)
    torch.testing.assert_close(llama.llama_hidden(params, toks, remat=True, **kw),
                               llama.llama_hidden(params, toks, **kw), rtol=0, atol=0)
