"""``train`` and ``cv``: the JAX package's ``engine.py`` (python-package
engine.py:17-425) for this port: the callback-driven loop, early stopping
by exception, ``learning_rates`` and ``evals_result`` through callbacks,
custom objectives and evaluation (``fobj``, ``feval``), continued
training (``init_model``), checkpoint resume (``checkpoint_dir``,
``checkpoint_every``; models/checkpoint.py), and cross-validation over
the JAX package's folds (``cv``, ``CVBooster``).  Both run on ``device``
("cuda" unless the caller asks for "cpu")."""
from __future__ import annotations

import collections
import os
from typing import Any, Dict

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset, _InnerPredictor
from .callback import CallbackEnv
from .io.dataset import TrainingData
from .models import checkpoint as ckpt_mod
from .parallel.comm import vote_stop
from .utils.config import key_alias_transform
from .utils.log import LightGBMError, Log

__all__ = ["train", "cv", "CVBooster", "CallbackEnv"]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None, feature_name="auto",
          categorical_feature="auto", early_stopping_rounds=None,
          evals_result=None, verbose_eval=True, learning_rates=None,
          keep_training_booster=False, callbacks=None,
          device="cuda") -> Booster:
    """Train a booster on ``device`` (python-package engine.py:17-203).
    ``train_set``: a Dataset, or the path of a pre-binned directory
    (``Dataset.save_binned``, ``ooc_binned_dir``).

    evals_result: a dict filled as ``{valid_name: {metric: [values]}}``.
    verbose_eval: log the evaluation every iteration (True) or every
    ``verbose_eval`` iterations.  early_stopping_rounds (or the
    ``early_stopping_round`` param): stop when no valid metric has
    improved for that many rounds; ``best_iteration`` is then the best
    round + 1 and every tree is kept.  learning_rates: a list or
    f(round) schedule of the learning rate.  callbacks: callables given a
    CallbackEnv after each iteration (before it, where their
    ``before_iteration`` is set), in the order of their ``order``.

    fobj(preds, train_data) -> (grad, hess): a custom objective at the
    raw scores (objective "none": the booster has no built-in one and no
    boost-from-average stub), trained on the staged chain.
    feval(preds, data) -> (name, value, higher is better), or a list of
    them: more evaluation at the raw scores of every evaluated set.
    feature_name, categorical_feature: set on train_set before training.

    init_model: a model file's path or a Booster to continue from: the
    training (and valid) scores start from its raw scores on the f64 host
    trees, its trees come first in the new booster, and
    ``num_boost_round`` more rounds run.  checkpoint_dir (param): when it
    holds a checkpoint of a run with the same training parameters (and no
    init_model is given), the run resumes from it and only the rounds
    left of ``num_boost_round`` run; with checkpoint_every (param) > 0 a
    checkpoint is written every that many rounds, counted from the first
    run, and at the end of the run (so that a later run with more rounds
    resumes where this one ended; the JAX package writes only the former)."""
    params = key_alias_transform(dict(params or {}))
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if params.get("early_stopping_round") is not None:
        early_stopping_rounds = int(params.pop("early_stopping_round"))
    if fobj is not None:
        params["objective"] = "none"
    if isinstance(train_set, str) and TrainingData.can_load_binned(train_set):
        # a pre-binned directory (io/binned_format.py) opens as it is:
        # its binning was paid when it was written
        train_set = Dataset.from_binned(train_set)
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")

    ck_dir = str(params.get("checkpoint_dir", "") or "")
    ck_every = int(params.get("checkpoint_every", 0) or 0)
    resumed = None
    if ck_dir and init_model is None:
        resumed = ckpt_mod.load_checkpoint(ck_dir)
        if resumed is not None:
            ckpt_mod.check_resumable(resumed, params)
    predictor = None
    if isinstance(init_model, str):
        predictor = _InnerPredictor(model_file=init_model)
    elif isinstance(init_model, Booster):
        predictor = _InnerPredictor(booster=init_model)
    elif init_model is not None:
        raise TypeError("init_model should be a model file path or a "
                        "Booster, met %s" % type(init_model).__name__)
    elif resumed is not None:
        predictor = _InnerPredictor(model_str=resumed["model"])
        done = int(resumed["iteration"])
        num_boost_round = max(0, num_boost_round - done)
        Log.info("Resuming from checkpoint %s: %d round(s) done, %d remain",
                 ck_dir, done, num_boost_round)
    init_iteration = (len(predictor.gbdt.models)
                      // max(predictor.gbdt.num_tree_per_iteration, 1)
                      if predictor is not None else 0)
    # rounds done since the first run: a checkpoint counts them, and a
    # twice-resumed run goes on counting
    rounds_base = (int(resumed["iteration"]) if resumed is not None
                   else init_iteration)
    train_set._update_params(params)
    if predictor is not None:
        train_set._set_predictor(predictor)
    if feature_name != "auto":
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
    booster = Booster(params=params, train_set=train_set, device=device)
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    include_train = False
    for i, vd in enumerate(valid_sets or []):
        name = (valid_names[i] if valid_names is not None
                and i < len(valid_names) else "valid_%d" % i)
        if vd is train_set:
            include_train = True
            booster.set_train_data_name(name)
            continue
        if not isinstance(vd, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            "met %s" % type(vd).__name__)
        vd.set_reference(train_set)
        booster.add_valid(vd, name)

    # the ranks of a distributed learner: only rank 0 writes checkpoints
    # and prints evaluations (the JAX package's rank gates); every rank
    # evaluates, over its rows reduced across the ranks, and they vote
    # on an early stop
    comm = booster._gbdt._dist_comm()
    rank0 = comm is None or comm.rank == 0
    world = 1 if comm is None else int(comm.size)
    if not rank0:
        verbose_eval = False
    obs = booster._gbdt._obs
    ck_world = (int(resumed.get("world_size", 1) or 1)
                if resumed is not None else world)
    if ck_world != world and obs.enabled:
        # an elastic shrink-and-resume (parallel/elastic.py): the world
        # that resumes differs from the one that wrote the checkpoint
        obs.event("mesh_shrink", world_size_from=ck_world,
                  world_size_to=world, it=int(resumed["iteration"]),
                  reason="resume",
                  checkpoint=ckpt_mod.checkpoint_path(ck_dir))

    def save_checkpoint(rounds):
        obs.stamp_context(stage="checkpoint", it=rounds)
        path = ckpt_mod.save_checkpoint(ck_dir, booster._gbdt, rounds,
                                        params, world_size=world)
        if obs.enabled:
            obs.event("checkpoint", it=rounds, path=path,
                      bytes=int(os.path.getsize(path)), world_size=world)
    cbs = set(callbacks or [])
    if learning_rates is not None:
        cbs.add(callback_mod.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    cbs_before, cbs_after = _assemble_callbacks(cbs, verbose_eval,
                                                early_stopping_rounds)

    booster.best_iteration = -1
    results = []
    begin, end = init_iteration, init_iteration + num_boost_round
    rounds_done = saved = rounds_base
    try:
        for i in range(begin, end):
            for cb in cbs_before:
                cb(CallbackEnv(booster, params, i, begin, end, None))
            # as in the JAX package, a stop the update reports (an
            # iteration without splits) ends nothing: its trees were
            # popped
            booster.update(fobj=fobj)
            rounds_done = rounds_base + (i - begin) + 1
            if (ck_dir and ck_every > 0 and rounds_done % ck_every == 0
                    and rank0):
                save_checkpoint(rounds_done)
                saved = rounds_done
            results = []
            if valid_sets is not None or feval is not None:
                # an anomaly firing here happened during eval
                obs.stamp_context(stage="eval", it=i)
                if include_train:
                    results.extend(booster.eval_train(feval))
                results.extend(booster.eval_valid(feval))
                # the metric values are also the timeline's eval event
                # and the drift fingerprint's eval snapshot
                if results:
                    evals = [{"dataset": str(n), "metric": str(m),
                              "value": float(v)} for n, m, v, _ in results]
                    booster._gbdt._last_eval_results = evals
                    booster._gbdt._drift_fingerprint = None
                    if obs.enabled:
                        obs.event("eval", it=i, results=evals)
            stop = None
            try:
                for cb in cbs_after:
                    cb(CallbackEnv(booster, params, i, begin, end, results))
            except callback_mod.EarlyStopException as e:
                stop = e
            if vote_stop(comm, stop is not None):
                booster.best_iteration = stop.best_iteration + 1
                results = stop.best_score
                break
    except BaseException:
        # a run that raised still ends its timeline: run_end with
        # status "aborted", and the writer flushed
        booster.finalize_telemetry(status="aborted")
        raise
    if ck_dir and ck_every > 0 and rounds_done != saved and rank0:
        save_checkpoint(rounds_done)
    booster.best_score = collections.defaultdict(dict)
    for data_name, eval_name, score, _ in results or []:
        booster.best_score[data_name][eval_name] = score
    booster.finalize_telemetry()
    if obs.enabled and obs.events_path:
        Log.debug("obs: timeline %s (query: python -m lightgbm_tpu_torch "
                  "obs summary %s)", obs.events_path, obs.events_path)
    return booster


def _assemble_callbacks(cbs, verbose_eval, early_stopping_rounds,
                        show_stdv: bool = True):
    """The implicit print and early-stop callbacks from the keyword
    arguments, then the callbacks before and after an iteration, each
    sorted by ``order`` (the JAX package's engine.py:300-320); train and
    cv share it."""
    cbs = set(cbs)
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation(show_stdv=show_stdv))
    elif (isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool)
          and verbose_eval):
        cbs.add(callback_mod.print_evaluation(verbose_eval, show_stdv))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds,
                                            verbose=bool(verbose_eval)))
    before = {cb for cb in cbs if getattr(cb, "before_iteration", False)}
    after = cbs - before

    def key(cb):
        return getattr(cb, "order", 0)
    return sorted(before, key=key), sorted(after, key=key)


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: dict,
                  seed: int, fpreproc=None, stratified: bool = False,
                  shuffle: bool = True):
    """The folds of cv (engine.py:227-286), the JAX package's for the
    same seed: scikit-learn's StratifiedKFold folds when stratified
    (_stratified_folds, without needing scikit-learn), else a numpy
    ``default_rng(seed)`` permutation cut into nfold runs, the last one
    taking the remainder; or the caller's ``folds`` (pairs of row
    indices, or an object with ``split``).  Each fold's rows are sorted
    and taken with Dataset.subset.  Returns [(train, valid, params)]."""
    full_data = full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and hasattr(folds, "split"):
            folds = folds.split(X=np.zeros(num_data),
                                y=full_data.get_label())
    elif stratified:
        folds = _stratified_folds(full_data.get_label(), nfold, shuffle,
                                  seed)
    else:
        rng = np.random.default_rng(seed)
        randidx = (rng.permutation(num_data) if shuffle
                   else np.arange(num_data))
        kstep = int(num_data / nfold)
        folds = []
        for k in range(nfold):
            test_id = randidx[k * kstep:(k + 1) * kstep if k + 1 < nfold
                              else num_data]
            train_id = np.setdiff1d(randidx, test_id, assume_unique=True)
            folds.append((train_id, test_id))
    ret = []
    for train_idx, test_idx in folds:
        train_sub = full_data.subset(np.sort(np.asarray(train_idx)))
        valid_sub = full_data.subset(np.sort(np.asarray(test_idx)))
        if fpreproc is not None:
            train_sub, valid_sub, tparam = fpreproc(train_sub, valid_sub,
                                                    params.copy())
        else:
            tparam = params
        ret.append((train_sub, valid_sub, tparam))
    return ret


def _stratified_folds(label, nfold: int, shuffle: bool, seed: int):
    """The (train, test) row indices of scikit-learn's
    ``StratifiedKFold(nfold, shuffle=shuffle, random_state=seed)``
    (sklearn/model_selection/_split.py, its _make_test_folds) in numpy:
    the classes in order of first appearance, each fold's share of a
    class dealt round robin over the sorted labels, each class's fold
    numbers in blocks, shuffled by ``RandomState(seed)`` class by class
    when ``shuffle``."""
    y = np.asarray(label).reshape(-1)
    if y.dtype.kind == "f" and not np.all(np.isfinite(y) & (y == np.floor(y))):
        raise LightGBMError("stratified cv needs class labels (binary or "
                            "multiclass), got continuous ones")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    counts = np.bincount(y_encoded)
    if np.all(nfold > counts):
        raise LightGBMError("n_splits=%d cannot be greater than the number "
                            "of members in each class." % nfold)
    if nfold > counts.min():
        Log.warning("The least populated class in y has only %d members, "
                    "which is less than n_splits=%d.", counts.min(), nfold)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::nfold],
                                         minlength=n_classes)
                             for i in range(nfold)])
    rng = np.random.RandomState(seed) if shuffle else None
    test_folds = np.empty(len(y), dtype=np.int32)
    for k in range(n_classes):
        folds_for_class = np.arange(nfold).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    rows = np.arange(len(y))
    return [(rows[test_folds != i], rows[test_folds == i])
            for i in range(nfold)]


class CVBooster:
    """The boosters of a cv run, one a fold (engine.py:206-224).  A
    method that is not a field of its own goes to every fold's booster
    and returns their results as a list: ``cvb.predict(X)`` is
    ``[b.predict(X) for b in cvb.boosters]``."""

    def __init__(self):
        self.boosters = []
        self.best_iteration = -1

    def append(self, booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def handler(*args, **kwargs):
            return [getattr(bst, name)(*args, **kwargs)
                    for bst in self.boosters]
        return handler


def cv(params, train_set, num_boost_round: int = 10, folds=None,
       nfold: int = 5, stratified: bool = False, shuffle: bool = True,
       metrics=None, fobj=None, feval=None, init_model=None,
       feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       device="cuda"):
    """Cross-validation on ``device`` (python-package engine.py:288-425):
    a booster a fold (_make_n_folds), each trained one round at a time
    and evaluated on its held-out rows; returns {"<metric>-mean": [...],
    "<metric>-stdv": [...]} a round.  The callbacks see the CVBooster as
    ``env.model`` and ("cv_agg", metric, mean, higher is better, stdv)
    results; early stopping cuts the lists at the best round.
    init_model: each fold continues from the model (its training rows'
    scores start from the model's raw scores); feature_name and
    categorical_feature: set on train_set first, as in train."""
    params = key_alias_transform(dict(params or {}))
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if metrics:
        params["metric"] = metrics
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    if feature_name != "auto":
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
    predictor = None
    if isinstance(init_model, str):
        predictor = _InnerPredictor(model_file=init_model)
    elif isinstance(init_model, Booster):
        predictor = _InnerPredictor(booster=init_model)
    elif init_model is not None:
        raise TypeError("init_model should be a model file path or a "
                        "Booster, met %s" % type(init_model).__name__)

    results = collections.defaultdict(list)
    cvfolds = _make_n_folds(train_set, folds, nfold, params, seed,
                            fpreproc=fpreproc, stratified=stratified,
                            shuffle=shuffle)
    cvbooster = CVBooster()
    for train_sub, valid_sub, tparam in cvfolds:
        if predictor is not None:
            train_sub._set_predictor(predictor)
        bst = Booster(params=tparam, train_set=train_sub, device=device)
        bst.add_valid(valid_sub, "valid")
        cvbooster.append(bst)

    cbs_before, cbs_after = _assemble_callbacks(callbacks or [],
                                                verbose_eval,
                                                early_stopping_rounds,
                                                show_stdv)
    try:
        for i in range(num_boost_round):
            for cb in cbs_before:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round, None))
            cvbooster.update(fobj=fobj)
            agg = collections.defaultdict(list)
            for fold_evals in cvbooster.eval_valid(feval):
                for _, name, score, hb in fold_evals:
                    agg[(name, hb)].append(score)
            res = []
            for (name, hb), scores in agg.items():
                mean, stdv = float(np.mean(scores)), float(np.std(scores))
                results[name + "-mean"].append(mean)
                results[name + "-stdv"].append(stdv)
                res.append(("cv_agg", name, mean, hb, stdv))
            try:
                for cb in cbs_after:
                    cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round,
                                   res))
            except callback_mod.EarlyStopException as e:
                cvbooster.best_iteration = e.best_iteration + 1
                for k in list(results.keys()):
                    results[k] = results[k][:e.best_iteration + 1]
                break
    except BaseException:
        cvbooster.finalize_telemetry(status="aborted")
        raise
    cvbooster.finalize_telemetry()     # every fold's timeline
    return dict(results)
