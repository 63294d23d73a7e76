"""Fused boosting iteration: one boosting step as a few CUDA graph replays.

Ported from the JAX package's ``ops/fused_iter.py``, which traces the
objective's gradients, the grow ``lax.while_loop`` and the score update
into one jitted entry a tree.  The port's staged chain
(``models/gbdt.py``) instead launches every torch operation of every
wave or split from Python and reads the device between them.  Here one
iteration on the card is:

1. the tree graph: gradients, weight rows and fixed-point exponents,
   the root and a fixed number of masked passes, ending in the state's
   status vector.  Under wave growth the passes are M masked waves
   (``wave_count``: the waves a tree takes when every leaf splits);
   under exact growth, S gated splits (``SPLIT_BLOCK``);
2. one host read of that status (done, splits, deepest leaf, passes
   that split);
3. only if the tree is not finished, replays of a tail graph, each
   followed by a read: one wave under wave growth (exact-order trees
   take more waves than M, and a wave costs far more than a read), S
   splits under exact growth;
4. the score-update graph (kernel B2, in place).

A masked pass with nothing to split is an exact no-op on the state, so
the passes past a tree's end change nothing, and the block sizes move
only the count of reads and replays, never the trees.

Every graph reads and writes tensors allocated once, outside any
capture (the grower's state, the weight rows, the row multipliers and
the feature mask), so a replay sees this iteration's inputs at the
captured addresses; the shrinkage is fixed for a booster and baked into
the score graph, which is captured again if it changes.  The first
iteration runs the same functions eagerly on a side stream: it is a real
iteration, and it sets what the kernels set once (their shared-memory
attributes, the cached launch plans) before the graphs are captured.
Kernel wrappers count their launches when Python calls them, which a
replay skips: each graph records the launches its capture made and adds
them on every replay.

On CPU tensors ``run`` executes the same schedule eagerly, so the CPU
tests cover it.  Fused and staged runs train byte-identical model text:
both run the grower's body and the same kernels
(tests/test_torch_fused_iter.py).
"""
from __future__ import annotations

import time

import torch

from ..device import CAPTURE_LOCK, capture_guard
from ..obs.events import NULL_OBSERVER
from ..obs.roofline import launches_cost
from ..utils.log import LightGBMError
from .grow import GrowStats
from .histogram import weight_rows
from .leaf_hist import leaf_histogram
from .predict import score_update, update_score_from_partition
from .sparse_mxu import sparse_wave_histogram
from .wave_kernels import (finish_hist, fixed_point_exponents,
                           wave_histogram, wave_histogram_rowmajor,
                           wave_partition_hist)

# every kernel wrapper that counts its launches (finish_hist: the
# conversion alone, which only the distributed learners launch)
KERNELS = (wave_partition_hist, wave_histogram, wave_histogram_rowmajor,
           leaf_histogram, sparse_wave_histogram, score_update, finish_hist)
# each wrapper's count, the counts of its forms, and the device
# operations of the wrappers that count them (B5's device_launches)
DEVICE = "device"
COUNTERS = ([(k, None) for k in KERNELS]
            + [(k, form) for k in KERNELS
               for form in sorted(getattr(k, "form_launches", {}))]
            + [(k, DEVICE) for k in KERNELS if hasattr(k, "device_launches")])


def _counts() -> list:
    return [k.launches if form is None else k.device_launches
            if form == DEVICE else k.form_launches[form]
            for k, form in COUNTERS]


def _set_counts(base, deltas) -> None:
    """Set each counter to its base plus its delta."""
    for (k, form), b, d in zip(COUNTERS, base, deltas):
        if form is None:
            k.launches = b + d
        elif form == DEVICE:
            k.device_launches = b + d
        else:
            k.form_launches[form] = b + d
# gated splits a graph holds under exact growth (S): a read each S
# splits, against a graph of about 420 nodes a split (PERF.md, PR 8)
SPLIT_BLOCK = 32


def wave_count(num_leaves: int, wave_width: int) -> int:
    """M, the waves a tree of num_leaves leaves takes at width
    wave_width when every leaf splits: a wave splits at most every leaf
    there is, so the leaves double until the width, then grow by it."""
    leaves, waves = 1, 0
    while leaves < num_leaves:
        leaves += min(leaves, wave_width, num_leaves - leaves)
        waves += 1
    return waves


def fused_supported(booster) -> tuple:
    """(ok, reason): can this booster's iteration be fused?  The JAX
    package's rules, by the same hooks and with its reasons: GBDT's own
    iteration (DART and InfiniteBoost override it) and its own bagging
    (GOSS overrides ``_bagging_with_grad`` to rescale the gradients), one
    tree an iteration, a built-in objective, the serial learner (under
    wave or exact growth), and no health monitors (obs_health).  The
    distributed learners run staged, which keeps every collective
    outside the CUDA graphs (capturing NCCL is later work)."""
    from ..models.gbdt import GBDT
    from .learner import SerialTreeLearner
    if getattr(booster.learner, "comm", None) is not None:
        return False, "distributed learner"
    if type(booster).train_one_iter is not GBDT.train_one_iter:
        return False, "boosting mode overrides train_one_iter (dart)"
    if type(booster)._bagging_with_grad is not GBDT._bagging_with_grad:
        return False, "gradient-rescaling bagging (goss)"
    if booster.num_tree_per_iteration != 1:
        return False, "num_tree_per_iteration > 1 (multiclass)"
    if booster.objective is None:
        return False, "no built-in objective (custom fobj)"
    if type(booster.learner) is not SerialTreeLearner:
        return False, "not the serial learner"
    if booster._obs.health is not None:
        # the health monitors read the gradients between the stages the
        # fused iteration's graphs hide: keep the staged chain
        return False, "obs_health gradient staging needs staged g/h"
    return True, ""


class _Graph:
    """A captured CUDA graph and the kernel launches its capture made.
    The capture is thread-local and holds the process's capture lock:
    another thread's CUDA work (a serving graph's capture or replay, a
    bulk predict) neither breaks it nor is broken by it.  A capture that
    fails raises with the caller's current stream restored
    (torch.cuda.graph leaves its capture stream current when the capture
    cannot end, and later work of the thread would land on a stream
    another capture may use)."""

    def __init__(self, fn):
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with capture_guard(), \
                    torch.cuda.stream(torch.cuda.current_stream()), \
                    torch.cuda.graph(self.graph,
                                     capture_error_mode="thread_local"):
                fn()
            self.launches = [a - b for a, b in zip(_counts(), before)]
        finally:
            # capturing launches nothing: the replays count
            _set_counts(before, [0] * len(before))

    def replay(self) -> None:
        self.graph.replay()
        _set_counts(_counts(), self.launches)


class FusedIteration:
    """One boosting step of a learner: gradients, growth and the score
    update, replayed as CUDA graphs on the card and run eagerly on the
    CPU.  Built once per booster (the learner and the objective are
    fixed for a training run).

    ``passes`` is the count of masked passes in the tree graph (waves,
    or gated splits under exact growth) and ``tail_len`` the count in a
    tail graph; a tree's ``GrowStats.tail_passes`` counts the passes its
    tail graphs ran, so it makes 1 + tail_passes / tail_len host
    reads."""

    def __init__(self, learner, grad_fn, num_data: int, grower=None,
                 score_engine: str = "pallas"):
        """``grower``: a wave grower other than the learner's own (the
        autotuner's probe of a candidate cell, ops/learner.py);
        ``score_engine``: the booster's score update, B2 ('pallas') or
        the gather (ops/predict.py update_score_from_partition).  The
        weights, gradients and scores are in the learner's dtype
        (float64 under tpu_use_dp)."""
        if learner.growth == "exact":
            self.grower = gr = learner.exact_grower()
            self._pass = gr.split
            self.passes = self.tail_len = max(1, min(SPLIT_BLOCK, gr.L - 1))
        else:
            self.grower = gr = grower or learner.wave_grower()
            self._pass = gr.wave
            self.passes = wave_count(gr.L, gr.W)
            self.tail_len = 1
        self.grad_fn = grad_fn
        self.score_engine = score_engine
        self.device = dev = learner.device
        self.dtype = dt = learner.dtype
        self.state = gr.new_state(num_data, dev)
        self.w3 = torch.empty((num_data, 3), dtype=dt, device=dev)
        self.exps = torch.empty(3, dtype=torch.int32, device=dev)
        self.row_mult = torch.empty(num_data, dtype=dt, device=dev)
        self.feature_mask = torch.empty_like(learner._full_mask)
        self._tree = self._tail = self._score = None
        self._score_key = None
        self.capture_seconds = 0.0     # set-up: capturing the graphs
        self.replays = 0               # graph replays so far
        # the run observer, told of every capture (obs/compile.py: in
        # the port a graph capture is a compile)
        self.observer = NULL_OBSERVER

    # ---------------------------------------------- the captured programs
    def tree_pass(self, score) -> None:
        """Gradients at score, the tree's weight rows and exponents, the
        root and the tree graph's masked passes, then the status; no
        host read."""
        g, h = self.grad_fn(score)
        self.w3.copy_(weight_rows(g.to(self.dtype), h.to(self.dtype),
                                  self.row_mult))
        self.exps.copy_(fixed_point_exponents(self.w3))
        self.grower.root(self.state, self.w3, self.exps, self.feature_mask)
        self._run(self.passes)

    def tail_pass(self) -> None:
        """A tail graph's masked passes, then the status."""
        self._run(self.tail_len)

    def _run(self, n: int) -> None:
        for _ in range(n):
            self._pass(self.state, self.w3, self.exps, self.feature_mask)
        self.grower.write_status(self.state)

    def score_pass(self, score, scale: float) -> None:
        """score += clip(scale * leaf_value)[leaf_id], in place (B2, or
        the gather)."""
        tree = self.grower.tree_of(self.state)
        update_score_from_partition(score, self.state.leaf_id,
                                    tree.leaf_value, scale, out=score,
                                    engine=self.score_engine)

    # ---------------------------------------------------------- schedule
    def _schedule(self, tree_step, tail_step, score_step):
        """The tree step, one read, tail steps until the tree is done,
        the score step: (TreeArrays, leaf_id, GrowStats)."""
        st = self.state
        tree_step()
        done, nn, depth, passes = st.status.tolist()
        reads = 1
        while not done:
            tail_step()
            done, nn, depth, passes = st.status.tolist()
            reads += 1
        score_step()
        stats = GrowStats(num_leaves=nn + 1, depth=depth, passes=passes,
                          host_reads=reads,
                          tail_passes=(reads - 1) * self.tail_len)
        return self.grower.tree_of(st), st.leaf_id, stats

    def _eager(self, score, scale):
        return self._schedule(lambda: self.tree_pass(score), self.tail_pass,
                              lambda: self.score_pass(score, scale))

    def _capture(self, score, scale) -> None:
        t0 = time.perf_counter()
        if self._tree is None:
            self._tree = self._graph("tree",
                                     lambda: self.tree_pass(score), score)
            self._tail = self._graph("tail", self.tail_pass, score)
        self._score = self._graph(
            "score", lambda: self.score_pass(score, scale), score, scale)
        self._score_key = (score.data_ptr(), float(scale))
        self.capture_seconds += time.perf_counter() - t0

    def _graph(self, name, fn, score, scale=None) -> _Graph:
        """Capture fn as graph ``fused_iter.<name>`` and tell the
        observer: the signature of the tensors it reads (and the score
        graph's baked-in scale), the seconds, and the cost of the kernel
        launches it recorded.  A capture that raises is no compile."""
        t0 = time.perf_counter()
        graph = _Graph(fn)
        obs = self.observer
        if obs.enabled:
            gr = self.grower
            args = [score, gr.X, self.w3, self.row_mult, self.feature_mask]
            names = ["score", "bins", "w3", "row_mult", "feature_mask"]
            if scale is not None:
                args.append(float(scale))
                names.append("scale")
            launches = {k.__name__: n for (k, form), n
                        in zip(COUNTERS, graph.launches) if form is None}
            obs.capture("fused_iter." + name, args, names=names,
                        seconds=time.perf_counter() - t0,
                        cost=launches_cost(launches, **self._shape()))
        return graph

    def _shape(self) -> dict:
        """The grower's sizes that launches_cost counts by."""
        gr = self.grower
        X = gr.X
        entries = (int(X.ent_row.numel()) if hasattr(X, "ent_row")
                   else int(X.nz_row.numel()) if hasattr(X, "nz_row")
                   else 0)
        return dict(n=int(self.w3.shape[0]), ncols=int(gr.hist_cols),
                    bins=int(gr.hist_bins), slots=int(gr.slots),
                    bin_bytes=(X.element_size()
                               if isinstance(X, torch.Tensor) else 4),
                    wide=self.dtype == torch.float64, entries=entries,
                    leaves=int(gr.L))

    def release(self) -> None:
        """Drop the captured graphs, which frees their memory pools; under
        the capture lock, so no capture of another thread is running."""
        with CAPTURE_LOCK:
            self._tree = self._tail = self._score = None
            self._score_key = None

    def _replay(self, graph) -> None:
        graph.replay()
        self.replays += 1

    def run(self, score, row_mult, feature_mask, scale: float):
        """One iteration: grow a tree on the gradients at score (N,) f32,
        with row multipliers row_mult (None: all ones) and the feature
        mask, and add clip(scale * leaf_value)[leaf_id] to score in place.
        Returns (TreeArrays, leaf_id, GrowStats); the tree and leaf ids
        are this object's buffers, overwritten by the next call."""
        if row_mult is None:
            self.row_mult.fill_(1.0)
        else:
            self.row_mult.copy_(row_mult)
        self.feature_mask.copy_(feature_mask)
        if self.device.type != "cuda":
            return self._eager(score, scale)
        if self._tree is None:
            # the warm-up: a real iteration, eager, on a side stream
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self._eager(score, scale)
            cur.wait_stream(side)
            self._capture(score, scale)
            return out
        if self._score_key != (score.data_ptr(), float(scale)):
            if self._score_key[0] != score.data_ptr():
                raise LightGBMError("the fused iteration's score tensor "
                                    "moved since its graphs were captured")
            self._capture(score, scale)
        return self._schedule(lambda: self._replay(self._tree),
                              lambda: self._replay(self._tail),
                              lambda: self._replay(self._score))
