"""Plotting utilities: the JAX package's ``plotting.py``
(python-package plotting.py:1-428): plot_importance, plot_metric,
create_tree_digraph, plot_tree and plot_importance_history.

An importance history comes from an obs timeline file (obs/query.py), a
list (``Booster.importance_history()`` results, or telemetry event
dicts) or a Booster trained with ``obs_importance_every``; a Booster
without importance events falls back to the snapshot plot."""
from __future__ import annotations

import numpy as np

from .basic import Booster
from .obs.model import importance_history
from .sklearn import LGBMModel


def _check_not_tuple_of_2_elements(obj, obj_name="obj"):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError("%s must be a tuple of 2 elements." % obj_name)


def _to_booster(booster):
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def _importance_history_from(source, importance_type):
    """The importance trajectory of a source: an obs timeline path, an
    importance_history() result, a list of telemetry event dicts, or a
    Booster/LGBMModel (its importance_history(); None when empty: the
    snapshot plot).  None means 'not a history source'."""
    if isinstance(source, str):
        from .obs.query import last_run, load_timeline
        return importance_history(last_run(load_timeline(source)),
                                  importance_type)
    if isinstance(source, (list, tuple)):
        src = list(source)
        if src and isinstance(src[0], dict) and "importance" in src[0]:
            return src                      # already a history result
        return importance_history(src, importance_type)
    if isinstance(source, (Booster, LGBMModel)):
        hist = _to_booster(source).importance_history(importance_type)
        return hist or None                 # no events -> snapshot plot
    return None


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    grid=True, **kwargs):
    """Bar chart of feature importances (plotting.py:18-112).

    ``booster`` may also be a telemetry event list or a
    ``Booster.importance_history()`` result — the bars then show the
    final ``importance`` snapshot (see plot_importance_history for the
    trajectory view)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot importance.")
    if isinstance(booster, (str, list, tuple)):
        hist = _importance_history_from(booster, importance_type)
        if not hist:
            raise ValueError("No importance events in the timeline (train "
                             "with obs_importance_every=N)")
        final = hist[-1]["importance"]
        nf = (max(final) + 1) if final else 0
        importance = np.zeros(nf)
        for f, v in final.items():
            importance[f] = v
        feature_names = ["Column_%d" % i for i in range(nf)]
    else:
        booster = _to_booster(booster)
        importance = booster.feature_importance(importance_type)
        feature_names = booster.feature_name()
    tuples = sorted(zip(feature_names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("Cannot plot trees with zero importance")
    labels, values = zip(*tuples)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(x), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_importance_history(source, importance_type="gain", ax=None,
                            max_num_features=10, xlim=None, ylim=None,
                            title="Feature importance evolution",
                            xlabel="Iterations", ylabel="auto",
                            figsize=None, grid=True, **kwargs):
    """Per-feature importance trajectories over training iterations.

    ``source``: an obs timeline path, a telemetry event list, an
    ``importance_history()`` result, or a Booster trained with
    ``obs_importance_every``; a source without importance events raises.
    One line per feature, top ``max_num_features`` by final
    importance."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot importance.")
    hist = _importance_history_from(source, importance_type)
    if not hist:
        raise ValueError("No importance events in the source (train with "
                         "obs_importance_every=N)")
    final = hist[-1]["importance"]
    top = sorted(final, key=lambda f: -final[f])
    if max_num_features is not None and max_num_features > 0:
        top = top[:max_num_features]
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    its = [h["it"] for h in hist]
    for f in top:
        ax.plot(its, [h["importance"].get(f, 0.0) for h in hist],
                label="Column_%d" % f, **kwargs)
    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    ax.set_ylabel("%s importance" % importance_type
                  if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None, xlim=None,
                ylim=None, title="Metric during training", xlabel="Iterations",
                ylabel="auto", figsize=None, grid=True):
    """Plot metric curves from evals_result (plotting.py:114-214)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot metric.")
    if isinstance(booster, LGBMModel):
        eval_results = dict(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = dict(booster)
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    names = dataset_names or list(eval_results.keys())
    first = eval_results[names[0]]
    if metric is None:
        metric = list(first.keys())[0]
    for name in names:
        if metric in eval_results.get(name, {}):
            results = eval_results[name][metric]
            ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index=0, show_info=None, precision=3,
                        name=None, comment=None, **kwargs):
    """Graphviz digraph of one tree (plotting.py:216-330)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree.")
    booster = _to_booster(booster)
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range.")
    tree_info = model["tree_info"][tree_index]
    show_info = show_info or []
    graph = Digraph(name=name, comment=comment, **kwargs)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            nid = "split%d" % node["split_index"]
            label = "split_feature_index: %d" % node["split_feature"]
            label += r"\nthreshold: %s" % round(node["threshold"], precision)
            for info in show_info:
                if info in node:
                    label += r"\n%s: %s" % (info, round(float(node[info]),
                                                        precision))
            graph.node(nid, label=label)
            add(node["left_child"], nid, "yes")
            add(node["right_child"], nid, "no")
        else:
            nid = "leaf%d" % node["leaf_index"]
            label = "leaf_index: %d" % node["leaf_index"]
            label += r"\nleaf_value: %s" % round(node["leaf_value"], precision)
            if "leaf_count" in show_info and "leaf_count" in node:
                label += r"\nleaf_count: %d" % node["leaf_count"]
            graph.node(nid, label=label)
        if parent is not None:
            graph.edge(parent, nid, decision)
        return nid

    add(tree_info["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index=0, figsize=None, graph_attr=None,
              node_attr=None, edge_attr=None, show_info=None, precision=3):
    """Render one tree with matplotlib via graphviz (plotting.py:332-428)."""
    try:
        import matplotlib.pyplot as plt
        import matplotlib.image as image
    except ImportError:
        raise ImportError("You must install matplotlib to plot tree.")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                graph_attr=graph_attr, node_attr=node_attr,
                                edge_attr=edge_attr)
    import io
    s = io.BytesIO()
    s.write(graph.pipe(format="png"))
    s.seek(0)
    img = image.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
