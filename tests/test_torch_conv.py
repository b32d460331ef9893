"""laser_tpu_torch's conv2d_direct and conv2d_im2col against laser_tpu's, the
same numpy inputs. On the CPU laser_tpu's shapes below reach each of its
three conv kernels in interpret mode (planewise; the patch kernel; the
per-tap kernel, taken for ow % 8 != 0), a strided conv its phase
decomposition, and a 1x1 conv its GEMM; the port runs its kernels' plain
versions on the routes its own rule picks (a strided conv: the direct
kernel's, which takes the stride; with ``plain=True`` laser_tpu's phases).
Tolerance: max |port - laser_tpu| <= 1e-5 of max |laser_tpu| in f32
(summation order only)."""

import numpy as np
import pytest
import torch

from laser_tpu.ops import conv as jconv
from laser_tpu_torch import registry
from laser_tpu_torch.ops import conv

REL = 1e-5

# (x shape, w shape, padding, strides, the port kernel the route reaches)
CASES = {
    "planewise": ((2, 3, 16, 16), (8, 3, 3, 3), (1, 1), (1, 1), "conv_planewise"),
    "patch": ((2, 8, 16, 16), (16, 8, 3, 3), (1, 1), (1, 1), "conv_direct"),
    "per_tap": ((1, 8, 13, 17), (6, 8, 3, 3), (1, 1), (1, 1), "conv_direct"),
    "strided": ((2, 8, 20, 20), (16, 8, 3, 3), (1, 1), (2, 2), "conv_direct"),
    "1x1": ((2, 16, 8, 8), (32, 16, 1, 1), (0, 0), (1, 1), None),
    "strided_5x5": ((1, 4, 17, 19), (6, 4, 5, 5), (2, 1), (3, 2), "conv_direct"),
}


def _inputs(name):
    xs, ws, *_ = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    return rng.randn(*xs).astype(np.float32), rng.randn(*ws).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """laser_tpu's conv2d_direct and conv2d_im2col on every case, once."""
    out = {}
    for name, (_, _, pad, st, _) in CASES.items():
        x, w = _inputs(name)
        out[name] = (np.asarray(jconv.conv2d_direct(x, w, padding=pad, strides=st)),
                     np.asarray(jconv.conv2d_im2col(x, w, padding=pad, strides=st)))
    return out


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", list(CASES))
def test_conv2d_direct_matches_laser_tpu(ref, name):
    _, _, pad, st, kernel = CASES[name]
    x, w = _inputs(name)
    registry.reset_counts()
    got = conv.conv2d_direct(torch.from_numpy(x), torch.from_numpy(w), pad, st)
    assert _rel_err(got, ref[name][0]) <= REL
    used = {n for n, c in registry.counts().items() if c["plain_calls"]}
    assert used & {"conv_planewise", "conv_direct"} == ({kernel} if kernel else set())


@pytest.mark.parametrize("name", ["strided", "strided_5x5"])
def test_plain_strided_conv_takes_laser_tpus_phases(ref, name):
    """``plain=True`` sums laser_tpu's stride-1 phase convs (here all on
    the planewise kernel's plain version), where the kernel route is one
    direct conv at the stride."""
    _, _, pad, st, _ = CASES[name]
    x, w = (torch.from_numpy(a) for a in _inputs(name))
    registry.reset_counts()
    got = conv.conv2d_direct(x, w, pad, st, plain=True)
    assert _rel_err(got, ref[name][0]) <= REL
    used = {n for n, c in registry.counts().items() if c["plain_calls"]}
    assert used & {"conv_planewise", "conv_direct"} == {"conv_planewise"}


@pytest.mark.parametrize("name", list(CASES))
def test_conv2d_im2col_matches_laser_tpu(ref, name):
    _, _, pad, st, _ = CASES[name]
    x, w = _inputs(name)
    got = conv.conv2d_im2col(torch.from_numpy(x), torch.from_numpy(w), pad, st)
    assert _rel_err(got, ref[name][1]) <= REL


@pytest.mark.parametrize("name", ["planewise", "patch", "per_tap"])
def test_both_kernel_versions_agree_on_any_route(ref, name):
    """Each kernel's plain version computes the conv on the other's shapes
    too, so a route change in either package leaves the function alone."""
    xs, ws, pad, _, _ = CASES[name]
    x, w = (torch.from_numpy(a) for a in _inputs(name))
    assert _rel_err(conv.conv2d_planewise_reference(x, w, pad), ref[name][0]) <= REL
    assert _rel_err(conv.conv2d_direct_reference(x, w, pad), ref[name][0]) <= REL


@pytest.mark.parametrize("name", list(CASES))
def test_out_shape_and_ops_formula(name):
    xs, ws, pad, st, _ = CASES[name]
    assert conv.conv2d_out_shape(xs, ws, pad, st) == jconv.conv2d_out_shape(xs, ws, pad, st)
    assert conv.conv2d_required_ops(xs, ws, pad, st) == \
        jconv.conv2d_required_ops(xs, ws, pad, st)


def test_plain_route_counts_plain_versions_only():
    x, w = (torch.from_numpy(a) for a in _inputs("patch"))
    registry.reset_counts()
    a = conv.conv2d_direct(x, w, (1, 1), plain=True)
    assert registry.counts()["conv_direct"] == {"launches": 0, "plain_calls": 1}
    torch.testing.assert_close(a, conv.conv2d_direct(x, w, (1, 1)), rtol=0, atol=0)


def test_rejects_a_channel_mismatch_and_an_empty_output():
    x = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError, match="channel mismatch"):
        conv.conv2d_direct(x, torch.zeros(2, 4, 3, 3))
    with pytest.raises(ValueError, match="empty output"):
        conv.conv2d_direct(x, torch.zeros(2, 3, 5, 5))
