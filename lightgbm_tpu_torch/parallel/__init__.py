"""Distributed training over ``torch.distributed``: one process (or, in
tests, one thread) a rank, one device a rank.

``comm`` holds the host and tensor collectives and the bootstrap,
``mesh`` the data-, voting- and feature-parallel learners, ``launch``
the subprocess launcher, ``worker`` its training worker and
``elastic`` the shrink-and-resume loop.  Ported from the JAX
package's ``parallel/``."""
from .comm import (HostComm, SingleProcessComm, TorchDistComm,
                   distributed_init, run_ranks)
from .mesh import (DataParallelTreeLearner, FeatureParallelTreeLearner,
                   VotingParallelTreeLearner, create_tree_learner)

__all__ = ["HostComm", "SingleProcessComm", "TorchDistComm",
           "distributed_init", "run_ranks", "DataParallelTreeLearner",
           "VotingParallelTreeLearner", "FeatureParallelTreeLearner",
           "create_tree_learner"]
