"""laser_tpu_torch AdamW, clipping and schedules against laser_tpu's.

Tolerance: max |port - laser_tpu| <= 1e-6 x max |laser_tpu| in f32:
the same fp32 expression on both sides (the bias corrections may differ by
an ulp of powf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_tpu.ops import optim as jopt
from laser_tpu_torch.convert import params_from_numpy, params_to_numpy
from laser_tpu_torch.ops import optim

REL = 1e-6


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _tree(rng):
    return {"w": rng.randn(7, 5).astype(np.float32),
            "blocks": [{"b": rng.randn(5).astype(np.float32)},
                       {"b": rng.randn(5).astype(np.float32)}]}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_adamw_steps_1_and_3_vs_laser_tpu():
    rng = np.random.RandomState(60)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jp, (jm, jv) = params, jopt.adamw_init(params)
    tp = params_from_numpy(params, device="cpu")
    tm, tv = optim.adamw_init(tp)
    for step in (1, 2, 3):
        jp, jm, jv = jopt.adamw_step(jp, grads[step - 1], jm, jv, step, lr=1e-2,
                                     weight_decay=0.1)
        optim.adamw_step(tp, params_from_numpy(grads[step - 1], device="cpu"), tm, tv,
                         step, lr=1e-2, weight_decay=0.1)
        if step in (1, 3):
            for mine, ref in ((tp, jp), (tm, jm), (tv, jv)):
                for a, b in zip(_leaves(params_to_numpy(mine)), _leaves(ref)):
                    assert _rel_err(a, b) <= REL


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_vs_laser_tpu(max_norm):
    g = _tree(np.random.RandomState(61))
    want, wnorm = jopt.clip_by_global_norm(g, max_norm)
    got, norm = optim.clip_by_global_norm(params_from_numpy(g, device="cpu"), max_norm)
    assert _rel_err(norm, wnorm) <= REL
    for a, b in zip(_leaves(params_to_numpy(got)), _leaves(want)):
        assert _rel_err(a, b) <= REL


@pytest.mark.parametrize("step", [1, 5, 10, 11, 60, 100, 150])
def test_schedules_vs_laser_tpu(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100, end_lr=1e-5)
    assert _rel_err(optim.warmup_cosine_lr(step, **kw),
                    jopt.warmup_cosine_lr(step, **kw)) <= REL
    assert _rel_err(optim.inverse_sqrt_lr(step, peak_lr=1e-3, warmup_steps=10),
                    jopt.inverse_sqrt_lr(step, peak_lr=1e-3, warmup_steps=10)) <= REL


def test_schedule_feeds_adamw_and_pallas_backend_raises():
    """A schedule's 0-d lr feeds both backends; since the fused kernel is
    ported, backend="pallas" runs it (here its plain version) and only an
    unknown backend raises."""
    for backend in (None, "pallas"):
        p = {"w": torch.ones(3)}
        m, v = optim.adamw_init(p)
        optim.adamw_step(p, {"w": torch.ones(3)}, m, v, 1,
                         lr=optim.warmup_cosine_lr(1, peak_lr=0.1, warmup_steps=1,
                                                   total_steps=10), backend=backend)
        torch.testing.assert_close(p["w"], torch.full((3,), 0.9))
    with pytest.raises(ValueError, match="unknown adamw backend"):
        optim.adamw_step(p, p, m, v, 1, lr=0.1, backend="mosaic")


def test_accumulation_equals_full_batch():
    rng = np.random.RandomState(62)
    w = {"a": torch.from_numpy(rng.randn(4, 3).astype(np.float32))}
    x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))

    def loss_fn(p, xb):
        return ((xb @ p["a"]) ** 2).mean()

    l1, g1 = optim.accumulated_value_and_grad(loss_fn, 1)(w, x)
    l2, g2 = optim.accumulated_value_and_grad(loss_fn, 4)(w, x)
    torch.testing.assert_close(l2, l1, rtol=1e-6, atol=0)
    torch.testing.assert_close(g2["a"], g1["a"], rtol=1e-6, atol=1e-7)
    assert not w["a"].requires_grad
    with pytest.raises(ValueError):
        optim.accumulated_value_and_grad(loss_fn, 3)(w, x)
