"""Optional-dependency shims (the JAX package's ``compat.py``,
python-package compat.py): whether pandas, scikit-learn, matplotlib and
graphviz can be imported, and stand-in ``DataFrame``/``Series`` classes
for isinstance checks where pandas is absent."""
from __future__ import annotations

try:
    import pandas as pd  # noqa: F401 — re-exported shim
    from pandas import DataFrame, Series  # noqa: F401
    PANDAS_INSTALLED = True
except ImportError:
    PANDAS_INSTALLED = False

    class DataFrame:  # type: ignore
        pass

    class Series:  # type: ignore
        pass

try:
    import sklearn  # noqa: F401
    SKLEARN_INSTALLED = True
except ImportError:
    SKLEARN_INSTALLED = False

try:
    import matplotlib  # noqa: F401
    MATPLOTLIB_INSTALLED = True
except ImportError:
    MATPLOTLIB_INSTALLED = False

try:
    import graphviz  # noqa: F401
    GRAPHVIZ_INSTALLED = True
except ImportError:
    GRAPHVIZ_INSTALLED = False
