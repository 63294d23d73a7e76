"""The port's static analyzer (the JAX package's ``analysis/``).

Five passes prove the hot-path invariants on a CPU-only host, each the
static twin of a runtime audit:

  hostsync   implicit device->host waits on torch values in ops/,
             models/gbdt.py, serve/, the ranks' comm and learners and
             the live plane (runtime twin: obs/timers.fence_count)
  recompile  CUDA graph captures and kernel builds inside loops
             (runtime twin: obs/compile.py's capture tracker)
  events     emit sites against the obs/events.py field tables
             (runtime twin: validate_event, which sees only runs)
  config     Config reads against utils/config.py and
             docs/Parameters.md
  smem       the kernels' launch planners over the autotuner's shape
             grid against the H100's shared memory

Entry point: ``python -m lightgbm_tpu_torch lint`` (analysis/cli.py).
"""
from .core import (Finding, LintInternalError, rule_catalog,  # noqa: F401
                   run_lint)
