"""Compact booster checkpoints: train, stop, resume.

The JAX package's ``models/checkpoint.py``.  A checkpoint records the
world size of the run that wrote it (rank 0 writes), so a run resumed on
fewer ranks (parallel/elastic.py) says so with a ``mesh_shrink`` event
(engine.train).  A checkpoint is
ONE JSON file, small by construction: the model text
(the same format save_model_to_string ships — trees only, no scores, no
dataset), the completed boosting-round count, the trajectory seeds, and
a fingerprint of the training-relevant parameters.  Scores are NOT
saved: continued training re-seeds them from the model's raw predictions
(the established init_model path, basic.py _InnerPredictor), and bagging
is re-drawn per iteration from ``default_rng(bagging_seed + it)`` — so
rounds + seeds fully determine the resumed trajectory.

Write is atomic (tmp file + ``os.replace`` in the same directory): a
process killed mid-save can never leave a half-written checkpoint to
resume from.  The file's format is the JAX package's, so either package
resumes the other's checkpoints.

The fingerprint covers the parameters that shape the trajectory and
deliberately EXCLUDES the ones a resume legitimately changes:
``dist_*`` topology, ``checkpoint_*`` knobs, observability paths, the
round count, and verbosity.  A mismatch
on anything else means the resume would silently train a different model
than the run that saved — engine.train refuses it loudly.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

from ..utils.log import LightGBMError

CHECKPOINT_SCHEMA = 1
_FILE = "checkpoint.json"

# trajectory seeds snapshotted into the checkpoint (informational — the
# fingerprint already pins them; surfacing them makes flight-record
# forensics self-contained)
_SEED_KEYS = ("seed", "bagging_seed", "data_random_seed",
              "feature_fraction_seed", "drop_seed")


def _excluded(key: str) -> bool:
    key = key.lower()
    return (key.startswith("obs_")
            or key.startswith("dist_")
            or key.startswith("checkpoint_")
            or key.startswith("verbos")
            or key in ("num_iterations", "num_boost_round", "num_threads",
                       "output_model", "snapshot_freq", "machine_list_file"))


def config_fingerprint(params: Dict[str, Any]) -> str:
    """Order-independent sha256 over the training-relevant raw params.
    ``params`` should already be alias-transformed (engine.train's are)
    so spellings of the same knob fingerprint identically."""
    h = hashlib.sha256()
    for k, v in sorted((str(k), str(v)) for k, v in dict(params).items()
                       if not _excluded(str(k))):
        h.update(k.encode())
        h.update(b"=")
        h.update(v.encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


def checkpoint_path(ckdir: str) -> str:
    return os.path.join(str(ckdir), _FILE)


def save_checkpoint(ckdir: str, gbdt, iteration: int,
                    params: Dict[str, Any], world_size: int = 1) -> str:
    """Atomically write the checkpoint; returns its path.  ``iteration``
    is the TOTAL completed boosting-round count (including rounds done
    before any earlier resume), so a twice-resumed run still counts
    rounds from the original zero."""
    ckdir = str(ckdir)
    os.makedirs(ckdir, exist_ok=True)
    cfg = getattr(gbdt, "config", None)
    payload = {
        "schema": CHECKPOINT_SCHEMA,
        "t": time.time(),
        "iteration": int(iteration),
        "world_size": int(world_size),
        "config_fingerprint": config_fingerprint(params),
        "seeds": {k: int(getattr(cfg, k)) for k in _SEED_KEYS
                  if cfg is not None and hasattr(cfg, k)},
        "model": gbdt.save_model_to_string(),
    }
    path = checkpoint_path(ckdir)
    fd, tmp = tempfile.mkstemp(dir=ckdir, prefix=".ckpt.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(ckdir: str) -> Optional[Dict[str, Any]]:
    """The checkpoint dict, or None when the directory holds none."""
    path = checkpoint_path(ckdir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        ck = json.load(f)
    if int(ck.get("schema", -1)) != CHECKPOINT_SCHEMA:
        raise LightGBMError(
            "checkpoint %s has schema %s; this build reads schema %d"
            % (path, ck.get("schema"), CHECKPOINT_SCHEMA))
    return ck


def check_resumable(ck: Dict[str, Any], params: Dict[str, Any]) -> None:
    """Refuse a resume that would train a different model than the run
    that saved (fingerprint over training-relevant params)."""
    want = config_fingerprint(params)
    have = str(ck.get("config_fingerprint", ""))
    if have != want:
        raise LightGBMError(
            "checkpoint config fingerprint %s does not match this run's "
            "%s — the training-relevant parameters changed since the "
            "checkpoint was written; refusing to resume (delete the "
            "checkpoint or restore the original parameters)"
            % (have, want))
