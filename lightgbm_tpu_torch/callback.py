"""Training callbacks: the JAX package's ``callback.py`` (python-package
callback.py), with ``CallbackEnv``'s fields and ``early_stopping``
raising ``EarlyStopException``.  A callback's ``order`` sorts it among
the others, and ``before_iteration`` runs it before the update
(engine.py ``_assemble_callbacks``).
"""
from __future__ import annotations

import collections
import inspect
from operator import gt, lt

from .utils.log import Log


class EarlyStopException(Exception):
    """Raised by callbacks to stop training (callback.py:14-24)."""

    def __init__(self, best_iteration, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "LightGBMCallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return "%s's %s: %g" % (value[0], value[1], value[2])
    if len(value) == 5:
        if show_stdv:
            return "%s's %s: %g + %g" % (value[0], value[1], value[2],
                                         value[4])
        return "%s's %s: %g" % (value[0], value[1], value[2])
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True):
    """Log the evaluation every ``period`` iterations."""
    def callback(env: CallbackEnv):
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            Log.info("[%d]\t%s", env.iteration + 1, result)
    callback.order = 10
    return callback


def record_evaluation(eval_result: dict):
    """Fill ``eval_result`` as {data name: {metric: [value a round]}}."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def init(env: CallbackEnv):
        for item in env.evaluation_result_list:
            eval_result.setdefault(item[0], collections.OrderedDict())
            eval_result[item[0]].setdefault(item[1], [])

    def callback(env: CallbackEnv):
        if not eval_result:
            init(env)
        for item in env.evaluation_result_list:
            eval_result[item[0]][item[1]].append(item[2])
    callback.order = 20
    return callback


def _schedule_arity(fn) -> int:
    """1 or 2: the required positional parameters of a reset_parameter
    schedule (a callable without a signature takes 1)."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return 1
    required = sum(
        1 for p in params
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        and p.default is p.empty)
    return 2 if required >= 2 else 1


def reset_parameter(**kwargs):
    """A parameter schedule applied before each iteration through
    Booster.reset_parameter: a list (one value a round), f(iteration) or
    f(iteration, num_boost_round).  Only changed values are reset."""
    arity = {k: _schedule_arity(v) for k, v in kwargs.items()
             if callable(v) and not isinstance(v, list)}

    def callback(env: CallbackEnv):
        new_parameters = {}
        rounds = env.end_iteration - env.begin_iteration
        it = env.iteration - env.begin_iteration
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != rounds:
                    raise ValueError("Length of list %s has to equal to "
                                     "'num_boost_round'." % key)
                new_param = value[it]
            elif callable(value):
                new_param = (value(it, rounds) if arity[key] >= 2
                             else value(it))
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting "
                                 "round index to new parameter value.")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    callback.before_iteration = True
    callback.order = 10
    return callback


def early_stopping(stopping_rounds: int, verbose: bool = True):
    """Stop when no metric has improved for stopping_rounds rounds
    (callback.py:133-204): raises EarlyStopException with the best
    round and its evaluation."""
    best_score = []
    best_iter = []
    best_score_list = []
    cmp_op = []

    def init(env: CallbackEnv):
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if verbose:
            Log.info("Train until valid scores didn't improve in %d rounds.",
                     stopping_rounds)
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:
                best_score.append(float("-inf"))
                cmp_op.append(gt)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lt)

    def callback(env: CallbackEnv):
        if not cmp_op:
            init(env)
        for i, eval_ret in enumerate(env.evaluation_result_list):
            score = eval_ret[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    Log.info("Early stopping, best iteration is:\n[%d]\t%s",
                             best_iter[i] + 1,
                             "\t".join(_format_eval_result(x)
                                       for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
    callback.order = 30
    return callback
