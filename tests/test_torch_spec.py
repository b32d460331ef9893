"""The port's decode bursts, burst pipelining and speculative decoding
against laser_tpu's, on laser_tpu-made params moved across with
``params_from_numpy`` (2 layers, d_model 64, vocab 97, as
tests/test_serving_spec.py).

- the verify steps (``_window_step``, ``_llama_window_step``): logits and the
  pools they write within 1e-4 of laser_tpu's on the same pools (f32);
- ``speculative_accept``: full acceptance, rejection with the residual
  draw, and the emitted token's empirical marginal against the target's
  distribution (total variation below 0.03 over 40000 draws: about four
  times its expected size at that count);
- burst engines (both families, pipelined and not) token-identical to
  ``decode_burst=1`` and to laser_tpu's plain engine; a sampled request
  identical at bursts 1 and 8;
- speculative engines token-identical to the port's plain engine for every
  case of tests/test_serving_spec.py that the port runs, and one case
  against laser_tpu's speculative engine with equal ``spec_tokens`` and
  ``spec_live_rounds`` (greedy acceptance is deterministic, so the two
  engines' rollback bookkeeping must agree);
- the configuration errors laser_tpu raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laser_tpu.config as jconfig
from laser_tpu.models.llama import init_llama as jinit_llama
from laser_tpu.models.transformer import init_transformer as jinit_transformer
from laser_tpu.ops.paged_attention import quantize_kv as jquantize_kv
from laser_tpu.serving import ServingConfig as JServingConfig
from laser_tpu.serving import ServingEngine as JServingEngine
from laser_tpu.serving import engine as jengine
from laser_tpu_torch.convert import params_from_numpy
from laser_tpu_torch.ops.sampling import (fold, gumbel, row_keys, row_seed,
                                          speculative_accept)
from laser_tpu_torch.serving import ServingConfig, ServingEngine
from laser_tpu_torch.serving import engine

V = 97


def _both(jparams):
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def tparams():
    return _both(jinit_transformer(jax.random.PRNGKey(0), n_layers=2, d_model=64,
                                   n_heads=4, d_ff=128, vocab=V))


@pytest.fixture(scope="module")
def tdraft():
    # a different, smaller model: acceptance near zero, so identity
    # exercises heavy rejection and the bonus-token path
    return _both(jinit_transformer(jax.random.PRNGKey(9), n_layers=1, d_model=32,
                                   n_heads=2, d_ff=64, vocab=V))


@pytest.fixture(scope="module")
def lparams():
    return _both(jinit_llama(jax.random.PRNGKey(1), n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=2, d_ff=128, vocab=V, max_len=256))


def _prompts(seed, n=4, lo=5, hi=40):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, rng.randint(lo, hi)).astype(np.int32) for _ in range(n)]


def _run(params, *, model="transformer", n_heads=4, draft=None, draft_n_heads=None,
         gamma=3, burst=8, kv_quant=False, pipeline=False, dwq=False, n_pages=64,
         max_new=20, eos=None, prompts, jax_engine=False, **req_kw):
    """One engine over ``prompts`` (the port's, or laser_tpu's): ({rid:
    tokens}, stats). Configuration as tests/test_serving_spec.py's."""
    Cfg, Eng = (JServingConfig, JServingEngine) if jax_engine else (ServingConfig,
                                                                     ServingEngine)
    cfg = Cfg(page_size=16, n_pages=n_pages, max_seqs=4, max_pages_per_seq=8,
              prefill_buckets=(16, 32, 64), decode_burst=burst, kv_quant=kv_quant,
              pipeline_bursts=pipeline, spec_gamma=gamma if draft is not None else 0,
              draft_weight_quant=dwq)
    eng = Eng(params, n_heads=n_heads, cfg=cfg, model=model, draft_params=draft,
              draft_n_heads=draft_n_heads)
    for p in prompts:
        eng.add_request(p, max_new, eos_id=eos, **req_kw)
    out = eng.run()
    return {k: [int(t) for t in v] for k, v in out.items()}, eng.stats


# ---------------------------------------------------------------------------
# The verify steps against laser_tpu's, on the same pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,kv_quant", [("transformer", False), ("llama", True)])
def test_window_step_matches_laser_tpu(tparams, lparams, model, kv_quant):
    jparams, params = tparams if model == "transformer" else lparams
    n_heads, hd, Hkv = 4, 16, 4 if model == "transformer" else 2
    ps, mp, S, W, L = 16, 4, 4, 4, 2
    P = S * mp + 1
    rng = np.random.RandomState(90)
    pools = rng.randn(L, 2, P, Hkv, ps, hd).astype(np.float32)
    tables = rng.permutation(P - 1)[:S * mp].reshape(S, mp).astype(np.int32)
    base = np.array([0, 9, 30, 14], np.int32)                  # slot 0 inactive
    live = base > 0
    pos = base[:, None] + np.arange(W)[None, :]
    remaining = np.array([0, 9, 2, 9])                         # slot 2: budget inside W
    wp = np.where(live[:, None] & (np.arange(W)[None, :] < remaining[:, None]),
                  tables[np.arange(S)[:, None], np.minimum(pos // ps, mp - 1)],
                  P - 1).astype(np.int32)
    wrow = (pos % ps).astype(np.int32)
    wtok = rng.randint(0, V, (S, W)).astype(np.int32)
    jkv = {"pools": jnp.asarray(pools)}
    kv = engine.KVPools(L, Hkv, hd, ServingConfig(page_size=ps, n_pages=P,
                                                  kv_quant=kv_quant), device="cpu")
    if kv_quant:
        pq, ps_ = map(np.array, jquantize_kv(jnp.asarray(pools)))
        jkv = {"pools": jnp.asarray(pq), "scales": jnp.asarray(ps_)}
        kv.pools.copy_(torch.from_numpy(pq))
        kv.scales.copy_(torch.from_numpy(ps_))
    else:
        kv.pools.copy_(torch.from_numpy(pools))
    jfn = jengine._window_step if model == "transformer" else jengine._llama_window_step
    fn = engine._window_step if model == "transformer" else engine._llama_window_step
    old = jconfig.get_config().paged_quant_mode
    try:
        jconfig.set_config(paged_quant_mode="base")
        jlog, jkv = jfn(jparams, jkv, jnp.asarray(tables), jnp.asarray(base),
                        jnp.asarray(live), jnp.asarray(wp), jnp.asarray(wrow),
                        jnp.asarray(wtok), n_heads=n_heads, page_size=ps)
    finally:
        jconfig.set_config(paged_quant_mode=old)
    t = torch.from_numpy
    log = fn(params, kv, t(tables), t(base).long(), t(live), t(wp), t(wrow), t(wtok),
             n_heads=n_heads, page_size=ps)
    assert log.shape == (S, W, V)
    assert np.abs(log.numpy() - np.asarray(jlog))[live].max() <= 1e-4
    # every page but the trash page, where dead rows collide in either order
    np.testing.assert_allclose(kv.pools.float().numpy()[:, :, :P - 1],
                               np.asarray(jkv["pools"], np.float32)[:, :, :P - 1], atol=1e-4)
    if kv_quant:
        np.testing.assert_allclose(kv.scales.numpy()[:, :, :P - 1],
                                   np.asarray(jkv["scales"])[:, :, :P - 1], rtol=1e-5)


# ---------------------------------------------------------------------------
# speculative_accept
# ---------------------------------------------------------------------------

def _keys(n, stream=0):
    return row_keys(torch.arange(n), torch.zeros(n, dtype=torch.int64), stream)


def test_device_keys_are_row_seed():
    s, p = torch.tensor([7, 7, 123456789]), torch.tensor([3, 4, 2 ** 31 + 5])
    assert row_keys(s, p).tolist() == [row_seed(a, b) for a, b in zip(s.tolist(), p.tolist())]
    assert len(set(fold(row_keys(s, p), 7).tolist())) == 3


def test_accept_full_and_reject_at_zero():
    gamma, N = 3, 4000
    eye = torch.eye(V)
    props = torch.tensor([[5, 17, 40]]).expand(N, -1)
    p = torch.stack([eye[5], eye[17], eye[40], eye[3]])[None].expand(N, -1, -1)
    n, nxt = speculative_accept(p, p[:, :gamma], props, _keys(N))
    assert (n == gamma).all() and (nxt == 3).all()
    # the target gives the first proposal no mass: rejected at 0, the next
    # token drawn from the residual max(p0 - q0, 0) = p0 over {8, 9}
    p0 = torch.zeros(V)
    p0[8], p0[9] = 0.25, 0.75
    p = torch.stack([p0, eye[17], eye[40], eye[3]])[None].expand(N, -1, -1)
    q = torch.stack([eye[5], eye[17], eye[40]])[None].expand(N, -1, -1)
    n, nxt = speculative_accept(p, q, props, _keys(N, 11))
    assert (n == 0).all() and set(nxt.tolist()) <= {8, 9}
    assert abs((nxt == 9).float().mean().item() - 0.75) < 0.03


def test_accept_marginal_is_the_target():
    """The first emitted token (a proposal when accepted, else the residual
    draw) is distributed as p[0], for a draft q far from p."""
    gamma, Vs, N = 3, 7, 40000
    rng = np.random.RandomState(91)
    p = torch.from_numpy(rng.dirichlet(np.ones(Vs), gamma + 1).astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.ones(Vs) * 0.3, gamma).astype(np.float32))
    keys = _keys(N, 7)
    props = torch.stack([torch.argmax(torch.log(q[i]) + gumbel(fold(keys, 20 + i), Vs), -1)
                         for i in range(gamma)], 1)
    n, nxt = speculative_accept(p.expand(N, -1, -1), q.expand(N, -1, -1), props,
                                _keys(N, 11))
    first = torch.where(n > 0, props[:, 0], nxt)
    emp = torch.bincount(first, minlength=Vs).float() / N
    assert 0.5 * (emp - p[0]).abs().sum().item() < 0.03
    assert 0 < (n == 0).float().mean().item() < 1  # both branches taken


# ---------------------------------------------------------------------------
# Decode bursts and pipelining
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_reference(lparams):
    """laser_tpu's plain llama engine (decode_burst 1) on _prompts(0)."""
    return _run(lparams[0], model="llama", burst=1, prompts=_prompts(0), jax_engine=True)[0]


@pytest.fixture(scope="module")
def transformer_reference(tparams):
    """laser_tpu's plain transformer engine (decode_burst 1) on _prompts(1)."""
    return _run(tparams[0], burst=1, prompts=_prompts(1), jax_engine=True)[0]


@pytest.fixture(scope="module")
def spec_reference(tparams, tdraft):
    """laser_tpu's speculative engine, the bad draft, on _prompts(1)."""
    return _run(tparams[0], draft=tdraft[0], draft_n_heads=2, prompts=_prompts(1),
                jax_engine=True)


@pytest.mark.parametrize("pipeline", [False, True], ids=["unpipelined", "pipelined"])
@pytest.mark.parametrize("model", ["transformer", "llama"])
def test_burst_engine_matches_single_step_and_laser_tpu(tparams, lparams, llama_reference,
                                                        transformer_reference, model, pipeline):
    params = (tparams if model == "transformer" else lparams)[1]
    prompts = _prompts(0 if model == "llama" else 1)
    want = llama_reference if model == "llama" else transformer_reference
    one, _ = _run(params, model=model, burst=1, prompts=prompts)
    burst, st = _run(params, model=model, burst=8, pipeline=pipeline, prompts=prompts)
    assert one == burst == want
    assert st["decode_bursts"] > 0


def test_sampled_request_same_at_any_burst(tparams):
    prompts = _prompts(2, n=3)
    kw = dict(temperature=0.9, top_k=30, top_p=0.95, seed=5)
    one, _ = _run(tparams[1], burst=1, prompts=prompts, **kw)
    eight, _ = _run(tparams[1], burst=8, pipeline=True, prompts=prompts, **kw)
    greedy, _ = _run(tparams[1], burst=1, prompts=prompts)
    assert one == eight and one != greedy


def test_burst_preemption_replays(tparams):
    """A pool too small for two requests: bursts fall back to the
    single-step path, which preempts; the tokens are unchanged."""
    prompts = _prompts(9, n=4, lo=30, hi=60)
    base, _ = _run(tparams[1], burst=1, prompts=prompts, max_new=24)
    small, st = _run(tparams[1], burst=8, pipeline=True, prompts=prompts, n_pages=13,
                     max_new=24)
    assert base == small and st.get("preemptions", 0) > 0


# ---------------------------------------------------------------------------
# Speculative decoding: token identity with the plain engine
# ---------------------------------------------------------------------------

def test_matches_laser_tpu_speculative_engine(tparams, tdraft, spec_reference,
                                              transformer_reference):
    want, jstats = spec_reference
    got, st = _run(tparams[1], draft=tdraft[1], draft_n_heads=2, prompts=_prompts(1))
    assert got == want == transformer_reference
    assert (st["spec_tokens"], st["spec_live_rounds"], st["spec_bursts"]) == \
        (jstats["spec_tokens"], jstats["spec_live_rounds"], jstats["spec_bursts"])


SPEC_CASES = {
    "self_draft": dict(seed=0, draft="self"),
    "bad_draft": dict(seed=1, draft="bad"),
    "int8_self_draft": dict(seed=2, draft="self", dwq="int8"),
    "int4_self_draft": dict(seed=2, draft="self", dwq="int4"),
    "llama": dict(seed=3, draft="self", model="llama"),
    "llama_int8kv_pipelined": dict(seed=4, draft="self", model="llama", kv_quant=True,
                                   pipeline=True),
    "gamma1": dict(seed=5, n=2, draft="self", gamma=1),
    "gamma2": dict(seed=5, n=2, draft="self", gamma=2),
    "gamma5": dict(seed=5, n=2, draft="self", gamma=5),
    "max_new1": dict(seed=7, n=2, draft="self", max_new=1),
    "max_new2": dict(seed=7, n=2, draft="self", max_new=2),
    "max_new7": dict(seed=7, n=2, draft="self", max_new=7),
    "page_exhaustion": dict(seed=9, lo=30, hi=60, draft="self", max_new=24, n_pages=13),
    "sharp_temperature": dict(seed=8, n=2, draft="self", temperature=1e-6, req_seed=3),
    # prompt + max_new fills the slot's 8 pages: the last windows reach past
    # the table, where the verify rows still see every key the table holds
    "at_capacity": dict(seed=11, n=2, lo=64, hi=65, draft="self", max_new=64),
    "llama_at_capacity": dict(seed=12, n=2, lo=64, hi=65, draft="self", model="llama",
                              max_new=64),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculative_engine_matches_plain_engine(tparams, tdraft, lparams, case):
    kw = dict(SPEC_CASES[case])
    model = kw.pop("model", "transformer")
    prompts = _prompts(kw.pop("seed"), n=kw.pop("n", 4), lo=kw.pop("lo", 5),
                       hi=kw.pop("hi", 40))
    params = (tparams if model == "transformer" else lparams)[1]
    draft = params if kw.pop("draft") == "self" else tdraft[1]
    dnh = None if draft is params else 2
    temperature, req_seed = kw.pop("temperature", 0.0), kw.pop("req_seed", 0)
    base_kw = {k: kw[k] for k in ("kv_quant", "max_new") if k in kw}
    base, _ = _run(params, model=model, prompts=prompts, **base_kw)
    spec, st = _run(params, model=model, draft=draft, draft_n_heads=dnh, prompts=prompts,
                    temperature=temperature, seed=req_seed, **kw)
    assert base == spec
    assert all(len(v) == kw.get("max_new", 20) for v in spec.values())
    if case == "page_exhaustion":
        assert st.get("preemptions", 0) > 0 or st["spec_bursts"] > 0
    elif case != "max_new1":  # one token comes from the prefill alone
        assert st["spec_live_rounds"] > 0
    if case == "self_draft":
        alpha = (st["spec_tokens"] / st["spec_live_rounds"] - 1) / 3
        assert alpha > 0.6, alpha  # window vs decode numerics: not exactly 1


def test_eos_mid_window(tparams):
    prompts = _prompts(6, n=2)
    base, _ = _run(tparams[1], prompts=prompts)
    eos = base[0][len(base[0]) // 2]  # a token known to appear
    base_e, _ = _run(tparams[1], prompts=prompts, eos=eos)
    spec_e, _ = _run(tparams[1], draft=tparams[1], prompts=prompts, eos=eos)
    assert base_e == spec_e
    assert any(out and out[-1] == eos for out in base_e.values())


def test_sampled_speculation_is_deterministic(tparams, tdraft):
    prompts = _prompts(10, n=3)
    kw = dict(draft=tdraft[1], draft_n_heads=2, prompts=prompts, temperature=1.0, seed=4)
    a, st = _run(tparams[1], **kw)
    b, _ = _run(tparams[1], pipeline=True, **kw)
    assert a == b and st["spec_live_rounds"] > 0
    assert all(0 <= t < V for v in a.values() for t in v)


# ---------------------------------------------------------------------------
# Configuration errors, as laser_tpu raises them
# ---------------------------------------------------------------------------

def test_config_errors(tparams, tdraft, lparams):
    params = tparams[1]
    with pytest.raises(ValueError, match="spec_gamma"):
        ServingEngine(params, n_heads=4, cfg=ServingConfig(spec_gamma=0), draft_params=params)
    with pytest.raises(ValueError, match="window"):
        ServingEngine(params, n_heads=4, cfg=ServingConfig(spec_gamma=2),
                      draft_params=params, window=8)
    with pytest.raises(ValueError, match="mesh"):
        ServingEngine(params, n_heads=4, cfg=ServingConfig(spec_gamma=2),
                      draft_params=params, mesh=object())
    bad = params_from_numpy(jax.tree.map(np.asarray, jinit_transformer(
        jax.random.PRNGKey(2), n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=V + 1)),
        device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(params, n_heads=4, cfg=ServingConfig(spec_gamma=2),
                      draft_params=bad, draft_n_heads=2)
    with pytest.raises(ValueError, match="draft_n_heads"):
        ServingEngine(params, n_heads=4, cfg=ServingConfig(spec_gamma=2),
                      draft_params=tdraft[1], draft_n_heads=3)
    short = params_from_numpy(jax.tree.map(np.asarray, jinit_llama(
        jax.random.PRNGKey(4), n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab=V, max_len=64)), device="cpu")
    with pytest.raises(ValueError, match="draft rope table"):
        ServingEngine(lparams[1], n_heads=4, model="llama", draft_params=short,
                      draft_n_heads=2, cfg=ServingConfig(page_size=16, max_pages_per_seq=8,
                                                         spec_gamma=2))
    eng = ServingEngine(params, n_heads=4, cfg=ServingConfig(spec_gamma=2),
                        draft_params=params)
    with pytest.raises(ValueError, match="temperature"):
        eng.add_request(np.array([1, 2, 3], np.int32), 4, temperature=0.8, top_k=5)
    with pytest.raises(ValueError, match="decode_burst"):
        ServingEngine(params, n_heads=4, cfg=ServingConfig(decode_burst=0))
    # options laser_tpu accepts and ignores: spec_gamma without a draft,
    # pipelining or a draft quantisation without bursts or a draft
    for kw in (dict(spec_gamma=2), dict(pipeline_bursts=True),
               dict(draft_weight_quant="int4")):
        assert not ServingEngine(params, n_heads=4, cfg=ServingConfig(**kw)).spec
    # still not ported
    for kw in (dict(cfg=ServingConfig(prefix_cache=True)), dict(window=8),
               dict(mesh=object())):
        with pytest.raises(NotImplementedError):
            ServingEngine(params, n_heads=4, **kw)
