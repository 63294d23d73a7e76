"""``train``: the JAX package's ``engine.train`` (python-package
engine.py:17-203) for this port: the callback-driven loop, early stopping
by exception, ``learning_rates`` and ``evals_result`` through callbacks,
continued training (``init_model``) and checkpoint resume
(``checkpoint_dir``, ``checkpoint_every``; models/checkpoint.py).
Custom objectives and evaluation (``fobj``, ``feval``), ``feature_name``
and ``categorical_feature`` here, and ``cv`` are not in the port yet;
asking for them raises."""
from __future__ import annotations

import collections
from typing import Any, Dict

from . import callback as callback_mod
from .basic import Booster, Dataset, _InnerPredictor
from .callback import CallbackEnv
from .models import checkpoint as ckpt_mod
from .utils.config import key_alias_transform
from .utils.log import LightGBMError, Log

__all__ = ["train", "CallbackEnv"]


def _not_yet(what: str) -> None:
    raise LightGBMError("%s is not in lightgbm_tpu_torch yet" % what)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None, feature_name="auto",
          categorical_feature="auto", early_stopping_rounds=None,
          evals_result=None, verbose_eval=True, learning_rates=None,
          keep_training_booster=False, callbacks=None,
          device="cuda") -> Booster:
    """Train a booster on ``device`` (python-package engine.py:17-203).

    evals_result: a dict filled as ``{valid_name: {metric: [values]}}``.
    verbose_eval: log the evaluation every iteration (True) or every
    ``verbose_eval`` iterations.  early_stopping_rounds (or the
    ``early_stopping_round`` param): stop when no valid metric has
    improved for that many rounds; ``best_iteration`` is then the best
    round + 1 and every tree is kept.  learning_rates: a list or
    f(round) schedule of the learning rate.  callbacks: callables given a
    CallbackEnv after each iteration (before it, where their
    ``before_iteration`` is set), in the order of their ``order``.

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
    for what, value in (("fobj", fobj), ("feval", feval)):
        if value is not None:
            _not_yet(what)
    for what, value in (("feature_name", feature_name),
                        ("categorical_feature", categorical_feature)):
        if value != "auto":
            _not_yet("train(%s=...)" % what)
    params = key_alias_transform(dict(params or {}))
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if params.get("early_stopping_round") is not None:
        early_stopping_rounds = int(params.pop("early_stopping_round"))
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
    booster = Booster(params=params, train_set=train_set, device=device)
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    include_train = False
    train_name = "training"
    for i, vd in enumerate(valid_sets or []):
        name = (valid_names[i] if valid_names is not None
                and i < len(valid_names) else "valid_%d" % i)
        if vd is train_set:
            include_train, train_name = True, name
            continue
        if not isinstance(vd, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            "met %s" % type(vd).__name__)
        vd.set_reference(train_set)
        booster.add_valid(vd, name)

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
    for i in range(begin, end):
        for cb in cbs_before:
            cb(CallbackEnv(booster, params, i, begin, end, None))
        # as in the JAX package, a stop the update reports (an iteration
        # without splits) ends nothing: its trees were popped
        booster.update()
        rounds_done = rounds_base + (i - begin) + 1
        if ck_dir and ck_every > 0 and rounds_done % ck_every == 0:
            ckpt_mod.save_checkpoint(ck_dir, booster._gbdt, rounds_done,
                                     params)
            saved = rounds_done
        results = []
        if valid_sets is not None:
            if include_train:
                results.extend(booster._eval(0, train_name))
            results.extend(booster.eval_valid())
        try:
            for cb in cbs_after:
                cb(CallbackEnv(booster, params, i, begin, end, results))
        except callback_mod.EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            results = stop.best_score
            break
    if ck_dir and ck_every > 0 and rounds_done != saved:
        ckpt_mod.save_checkpoint(ck_dir, booster._gbdt, rounds_done, params)
    booster.best_score = collections.defaultdict(dict)
    for data_name, eval_name, score, _ in results or []:
        booster.best_score[data_name][eval_name] = score
    return booster


def _assemble_callbacks(cbs, verbose_eval, early_stopping_rounds):
    """The implicit print and early-stop callbacks from the keyword
    arguments, then the callbacks before and after an iteration, each
    sorted by ``order`` (the JAX package's engine.py:300-320)."""
    cbs = set(cbs)
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation())
    elif (isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool)
          and verbose_eval):
        cbs.add(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds,
                                            verbose=bool(verbose_eval)))
    before = {cb for cb in cbs if getattr(cb, "before_iteration", False)}
    after = cbs - before

    def key(cb):
        return getattr(cb, "order", 0)
    return sorted(before, key=key), sorted(after, key=key)
