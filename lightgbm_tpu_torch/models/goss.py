"""GOSS booster (src/boosting/goss.hpp), as the JAX package's
``models/goss.py``.

Gradient-based One-Side Sampling: keep the rows whose |g*h| (summed over
the classes) reaches the top ``top_rate`` fraction's threshold (ties at
the threshold are kept), sample ``other_rate`` of the rest uniformly with
an exact count, and amplify the sampled rows' gradients by
``(n - top_k) / other_k`` (goss.hpp:79-125).  No sampling for the first
``int(1 / learning_rate)`` iterations (goss.hpp:128-130).  The selection
runs on the device in plain torch and hands the learner a 0/1 row
multiplier with the rescaled gradients.

The uniform keys are drawn on the host with
``np.random.default_rng(bagging_seed + it)`` (as ``GBDT._bagging`` draws
its keys) and uploaded, so the card and the CPU train the same model.
The JAX package draws ``jax.random.uniform(PRNGKey(bagging_seed + it))``,
which torch cannot reproduce: on the same seed the two packages sample
different rows (given the same keys, the same rows).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .gbdt import GBDT


class GOSS(GBDT):
    def __init__(self, config, device, train_data=None, objective=None,
                 training_metrics=()):
        super().__init__(config, device, train_data, objective,
                         training_metrics)
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            Log.fatal("cannot use bagging in GOSS")
        Log.info("Using GOSS")
        if train_data is not None:
            self.bag_data_cnt = self.num_data

    def _uniform(self, it: int, n: int) -> torch.Tensor:
        """The (n,) f32 uniform keys of iteration it, on the device."""
        rng = np.random.default_rng(self.config.bagging_seed + it)
        return torch.as_tensor(rng.random(n, dtype=np.float32),
                               device=self.device)

    def _bagging_with_grad(self, it: int, grad, hess):
        """The GOSS sample of iteration it from (K, N) gradients: sets
        row_mult and returns the rescaled gradients."""
        cfg = self.config
        self.row_mult = None
        if it < int(1.0 / cfg.learning_rate):
            return grad, hess
        n = self.num_data
        top_k = max(1, int(n * cfg.top_rate))
        other_k = int(n * cfg.other_rate)
        if other_k <= 0:
            return grad, hess
        multiply = (n - top_k) / other_k
        absg = (grad * hess).abs().sum(dim=0)
        # the top_k-th largest |g*h| (ArgMaxAtK, goss.hpp:90-92)
        threshold = torch.sort(absg, descending=True).values[top_k - 1]
        is_top = absg >= threshold
        # an exact-count uniform sample of the rest: the other_k smallest
        # keys among the rows not on top
        u = torch.where(is_top, torch.inf, self._uniform(it, n))
        kth = torch.sort(u).values[other_k - 1]
        sampled = ~is_top & (u <= kth)
        self.row_mult = (is_top | sampled).to(grad.dtype)
        scale = torch.where(sampled, float(np.float32(multiply)),
                            1.0).to(grad.dtype)
        return grad * scale[None, :], hess * scale[None, :]
