"""Boosting factory (src/boosting/boosting.cpp:30-62), as the JAX
package's ``models/factory.py``."""
from __future__ import annotations

from ..utils.log import Log
from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .infiniteboost import InfiniteBoost

BOOSTING_TYPES = {"gbdt": GBDT, "gbrt": GBDT, "dart": DART, "goss": GOSS,
                  "infinite": InfiniteBoost, "infiniteboost": InfiniteBoost}


def create_boosting(boosting_type: str, config, device, train_data=None,
                    objective=None, training_metrics=()):
    """The booster of ``boosting_type`` on ``device``."""
    cls = BOOSTING_TYPES.get(boosting_type)
    if cls is None:
        Log.fatal("Unknown boosting type %s", boosting_type)
    return cls(config, device, train_data, objective, training_metrics)
