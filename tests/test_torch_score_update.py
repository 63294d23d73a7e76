"""The port's partition-side score update (kernel B2's plain version and
its wrapper) is BIT-equal to the JAX package's Pallas kernel in
interpret mode and to its XLA gather form, on the cases the JAX package
pins for its own kernel: out-of-range leaf ids clamp to [0, L-1] and
large leaf values hit the kMaxTreeOutput clip."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.predict import (_update_score_gather,
                                      _update_score_pallas, kMaxTreeOutput)
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.ops.partition import (clipped_leaf_values,
                                              score_update_impl)
from torch_cases import SCORE_CASES as CASES, score_case as _case
from torch_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("n,L", CASES)
def test_plain_score_update_bit_equal_to_pallas_and_gather(n, L):
    score, lid, lv, scale = _case(n, L)
    want = np.asarray(_update_score_gather(
        jnp.asarray(score), jnp.asarray(lid), jnp.asarray(lv),
        jnp.asarray(scale)))
    vals = jnp.clip(jnp.asarray(lv) * scale, -kMaxTreeOutput,
                    kMaxTreeOutput)
    pallas = np.asarray(_update_score_pallas(
        jnp.asarray(score), jnp.asarray(lid), vals, interpret=True))
    assert np.array_equal(want, pallas)

    tvals = clipped_leaf_values(torch.from_numpy(lv), torch.tensor(scale))
    assert np.array_equal(tvals.numpy(), np.asarray(vals))
    got = tp.score_update(torch.from_numpy(score), torch.from_numpy(lid),
                          tvals)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    full = tp.update_score_from_partition(
        torch.from_numpy(score), torch.from_numpy(lid),
        torch.from_numpy(lv), torch.tensor(scale))
    assert np.array_equal(full.numpy(), want)
    impl = score_update_impl(torch.from_numpy(score), torch.from_numpy(lid),
                             torch.from_numpy(lv), torch.tensor(scale))
    assert np.array_equal(impl.numpy(), want)


def test_clip_is_applied_after_the_scale():
    lv = torch.tensor([1e3, -1e3, 0.5], dtype=torch.float32)
    v = clipped_leaf_values(lv, 0.1).numpy()
    assert v[0] == np.float32(100.0) and v[1] == np.float32(-100.0)
    v = clipped_leaf_values(lv, 1.0).numpy()
    assert v[0] == np.float32(kMaxTreeOutput)
    assert v[1] == np.float32(-kMaxTreeOutput)


@pytest.mark.parametrize("bad", ["dtype", "shape", "empty"])
def test_score_update_validates(bad):
    score = torch.zeros(8)
    lid = torch.zeros(8, dtype=torch.int32)
    vals = torch.zeros(3)
    if bad == "dtype":
        lid = lid.long()
    elif bad == "shape":
        lid = lid[:5]
    else:
        vals = vals[:0]
    with pytest.raises(tp.LightGBMError):
        tp.score_update(score, lid, vals)


def test_cpu_call_counts_no_launch():
    before = tp.score_update.launches
    tp.score_update(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                    torch.ones(2))
    assert tp.score_update.launches == before
