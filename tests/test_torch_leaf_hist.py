"""The port's leaf histogram (kernel B5, exact growth) against the JAX
package's Pallas kernel run in interpret mode and against its XLA scatter
histogram, on the same numpy inputs.

Tolerance: rtol 1e-5 with atol 1e-6 x max|w| (w = [g*m, h*m, m]), for
sums taken in another order than the port's f32 adds.  The Pallas kernel
multiplies 0/1 one-hot entries by f32 weights, so its products are exact
and only the order of its adds differs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.histogram import leaf_histogram_scatter
from lightgbm_tpu.ops.histogram import leaf_sums as jax_leaf_sums
from lightgbm_tpu.ops.pallas_hist import leaf_histogram_pallas
from lightgbm_tpu_torch.ops import leaf_hist as lh
from lightgbm_tpu_torch.ops import wave_kernels as wk
from lightgbm_tpu_torch.ops.histogram import leaf_sums, weight_rows
from lightgbm_tpu_torch.ops.wave_kernels import fixed_point_exponents
from torch_cases import LEAF_CASES, leaf_case, t
from torch_cases import one_torch_thread  # noqa: F401 (autouse)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port(X, g, h, lid, leaf, rm, b):
    return lh.leaf_histogram(t(X), t(g), t(h), t(lid), leaf,
                             None if rm is None else t(rm), b).numpy()


def _close(got, want, g, h, rm):
    m = np.ones_like(g) if rm is None else rm
    wmax = float(np.abs(np.stack([g * m, h * m, m])).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * wmax)


@pytest.mark.parametrize("n,f,b,kind,leaf", LEAF_CASES)
def test_plain_matches_pallas_and_scatter(n, f, b, kind, leaf):
    X, g, h, lid, rm = leaf_case(n, f, b, kind)
    got = _port(X, g, h, lid, leaf, rm, b)
    assert got.shape == (f, b, 3)
    args = (jnp.asarray(X), jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(lid), leaf, _j(rm))
    want = np.asarray(leaf_histogram_pallas(*args, num_bins=b,
                                            interpret=True))
    _close(got, want, g, h, rm)
    _close(got, np.asarray(leaf_histogram_scatter(*args, num_bins=b)), g, h,
           rm)
    if leaf == 9:
        assert np.all(got == 0.0)          # a leaf with no rows
    else:
        assert np.abs(got).sum() > 0


@pytest.mark.parametrize("kind", ["none", "fractional"])
def test_leaf_sums_match_the_jax_package(kind):
    X, g, h, lid, rm = leaf_case(2000, 3, 7, kind)
    got = leaf_sums(t(g), t(h), t(lid), 2, None if rm is None else t(rm))
    want = jax_leaf_sums(jnp.asarray(g), jnp.asarray(h), jnp.asarray(lid),
                         2, _j(rm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_leaf_as_a_device_tensor():
    """The grower passes the leaf as a one-element tensor (never read back
    to the host); int32 and int64 give the int's histogram."""
    X, g, h, lid, rm = leaf_case(1200, 4, 14, "fractional")
    want = _port(X, g, h, lid, 3, rm, 14)
    for dtype in (torch.int32, torch.int64):
        got = lh.leaf_histogram(t(X), t(g), t(h), t(lid),
                                torch.tensor([3], dtype=dtype), t(rm), 14)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrapper_does_not_count_launches():
    X, g, h, lid, rm = leaf_case(500, 3, 7, "none")
    before = lh.leaf_histogram.launches
    _port(X, g, h, lid, 1, rm, 7)
    assert lh.leaf_histogram.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "bins",
                                 "leaf", "w3", "exps"])
def test_wrapper_validates_inputs(bad):
    X, g, h, lid, rm = leaf_case(64, 3, 7, "fractional")
    args = [t(X), t(g), t(h), t(lid), 1, t(rm), 7]
    kw = {}
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "shape":
        args[5] = args[5][:10]
    elif bad == "device":
        args[2] = args[2].to("meta")
    elif bad == "bins":
        args[6] = 300
    elif bad == "leaf":
        args[4] = torch.tensor([1, 2])
    elif bad == "w3":
        kw["w3"] = weight_rows(*args[1:3], args[5])[:, :2]
    else:
        kw["exps"] = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(lh.LightGBMError):
        lh.leaf_histogram(*args, **kw)


@pytest.mark.parametrize("n,f,b,kind,leaf", LEAF_CASES)
def test_kernel_arguments_keep_the_plain_result(n, f, b, kind, leaf):
    """On the CPU the wrapper given the grower's w3= and exps= returns the plain histogram to the bit: the plain version uses
    grad, hess and row_mult, and the kernel's arguments only steer the
    kernel."""
    X, g, h, lid, rm = leaf_case(n, f, b, kind)
    args = [t(X), t(g), t(h), t(lid), leaf, None if rm is None else t(rm),
            b]
    w3 = weight_rows(*args[1:3], args[5])
    got = lh.leaf_histogram(*args, w3=w3, exps=fixed_point_exponents(w3))
    want = lh.leaf_histogram_plain(*args[:4], torch.tensor([leaf]),
                                   *args[5:])
    assert torch.equal(got, want)


@pytest.mark.parametrize("f,b", [(28, 63), (968, 255), (5, 14)])
def test_leaf_plan_holds_the_leaf_in_one_block(f, b):
    """B5's plan at the flagship's 28 features and 63 bins, and at 5 x 14,
    holds every feature's cells in one block, a call being the kernel and
    its conversion (a memset and the kernel when deferred); at 968 features of 255 bins one block cannot hold
    them, and B5 takes B4's plan at K = 1 (one slot, feature groups
    covering F, shares of at least a block's threads of rows)."""
    sms = 132                           # an H100's SMs
    plan = lh.leaf_plan(f, b)
    if f == 968:
        assert not plan.fused and lh.plan_launches(plan) == 4
        assert f * b * 24 > lh.LEAF_SMEM_BUDGET
        n = 2_000_000
        list_blocks, groups, R, ks, fs, copies, smem, ordered = \
            wk.hist_plan(f, n, b, 1, sms)
        assert not ordered and ks == 1 and groups * fs >= f
        assert smem == copies * fs * b * 3 * 8 <= wk._SMEM_BUDGET
        assert 1 <= R and R * wk._HIST_THREADS <= n
        return
    assert plan.fused and plan.smem == f * b * 24 <= lh.LEAF_SMEM_BUDGET
    assert lh.plan_launches(plan) == 2
    assert lh.plan_launches(plan, finish=False) == 2
