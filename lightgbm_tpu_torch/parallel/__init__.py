"""Distributed training over ``torch.distributed``: one process (or, in
tests, one thread) a rank, one device a rank.

``comm`` holds the host and tensor collectives and the bootstrap,
``mesh`` the data-, voting- and feature-parallel learners, ``launch``
the subprocess launcher and ``worker`` its training worker.  Ported from
the JAX package's ``parallel/``; its elastic driver is not here yet
(``elastic`` raises, naming ROADMAP A10b)."""
from .comm import (HostComm, SingleProcessComm, TorchDistComm,
                   distributed_init, run_ranks)
from .mesh import (DataParallelTreeLearner, FeatureParallelTreeLearner,
                   VotingParallelTreeLearner, create_tree_learner)

__all__ = ["HostComm", "SingleProcessComm", "TorchDistComm",
           "distributed_init", "run_ranks", "DataParallelTreeLearner",
           "VotingParallelTreeLearner", "FeatureParallelTreeLearner",
           "create_tree_learner"]
