from .tree import Tree
from .gbdt import GBDT
from .factory import create_boosting

__all__ = ["Tree", "GBDT", "create_boosting"]
