"""lightgbm_tpu_torch: the PyTorch + CUDA port of lightgbm_tpu.

The same gradient boosting system as the JAX package beside it, with the
device code in PyTorch and the TPU's Pallas kernels rewritten by hand in
CUDA C++ for Hopper (``csrc/``, built with ``nvcc`` on first use).  The
Python surface mirrors the JAX package's: ``Dataset``, ``Booster``,
``train``, ``cv``, the scikit-learn estimators, the plotting functions and
the text model format, which both packages read and write, and the
reference's command line (``python -m lightgbm_tpu_torch
config=train.conf``, cli.py) on text files.

Entry points (``train``, ``cv``, ``Booster``, the estimators) run on the
GPU (``device="cuda"``) unless the caller passes ``device="cpu"``; asking
for CUDA on a machine without it raises.
"""
from . import callback
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .convert_model import model_to_cpp
from .engine import CVBooster, cv, train
from .pmml import model_to_pmml
from .utils.log import LightGBMError

try:
    from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
    _SKLEARN_EXPORTS = ["LGBMModel", "LGBMRegressor", "LGBMClassifier",
                        "LGBMRanker"]
except ImportError:
    _SKLEARN_EXPORTS = []

try:
    from .plotting import (create_tree_digraph, plot_importance,
                           plot_importance_history, plot_metric, plot_tree)
    _PLOT_EXPORTS = ["plot_importance", "plot_metric", "plot_tree",
                     "create_tree_digraph", "plot_importance_history"]
except ImportError:
    _PLOT_EXPORTS = []

__version__ = "0.1.0"

__all__ = ["Dataset", "Booster", "train", "cv", "CVBooster",
           "LightGBMError", "EarlyStopException", "early_stopping",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "model_to_cpp", "model_to_pmml"] + _SKLEARN_EXPORTS + _PLOT_EXPORTS
