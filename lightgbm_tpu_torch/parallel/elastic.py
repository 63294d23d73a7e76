"""The JAX package's elastic driver (its ``parallel/elastic.py``):
resuming a checkpoint across a changed world size after a rank dies.
Not in the port yet (ROADMAP A10b): each entry raises, naming the item.
"""
from __future__ import annotations

from ..utils.log import LightGBMError


def _unported(what: str):
    raise LightGBMError("%s: the elastic driver (resuming a checkpoint "
                        "across a changed world size) is not in "
                        "lightgbm_tpu_torch yet (ROADMAP A10b)" % what)


def run_elastic(*args, **kwargs):
    """Elastic multi-process training (JAX ``run_elastic``): raises."""
    _unported("run_elastic")


def run_elastic_threads(*args, **kwargs):
    """Elastic thread-rank training (JAX ``run_elastic_threads``):
    raises."""
    _unported("run_elastic_threads")
