"""lightgbm_tpu_torch with device="cpu" bound in: what the python-guide
examples import when tests/test_torch_guide_examples.py runs them on the
CPU.  ``train``, ``cv``, ``Booster`` and the estimators default to the
CPU here; everything else is the package's own."""
import functools

import lightgbm_tpu_torch as _port
from lightgbm_tpu_torch import *  # noqa: F401,F403

train = functools.partial(_port.train, device="cpu")
cv = functools.partial(_port.cv, device="cpu")


class Booster(_port.Booster):
    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


class LGBMRegressor(_port.LGBMRegressor):
    def __init__(self, device="cpu", **kwargs):
        super().__init__(device=device, **kwargs)


class LGBMClassifier(_port.LGBMClassifier):
    def __init__(self, device="cpu", **kwargs):
        super().__init__(device=device, **kwargs)


class LGBMRanker(_port.LGBMRanker):
    def __init__(self, device="cpu", **kwargs):
        super().__init__(device=device, **kwargs)
