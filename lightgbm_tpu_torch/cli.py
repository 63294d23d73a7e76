"""Command-line application — parity with src/application/application.cpp,
as the JAX package's ``cli.py``.

Usage:  python -m lightgbm_tpu_torch config=train.conf [key=value ...]

CLI args override the config file (application.cpp:48-104).  Tasks:
train (data, valid data, training metric, ``input_model`` continued
training, ``checkpoint_dir``/``checkpoint_every`` resume, snapshots every
``snapshot_freq`` iterations, ``output_model``), predict (``%.9g``,
tab-separated for K > 1) and convert_model (C++ if-else source, like
GBDT::ModelToIfElse).  ``data`` may be a pre-binned directory; a dense
text file streams in two rounds under ``use_two_round_loading`` or
``ooc_binned_dir`` (which also writes the directory), and whenever it is
larger than ``io/dataset.py STREAM_BYTES`` (io/streaming.py).

Training and prediction run on the GPU unless ``device_type=cpu`` (or
``device=cpu``) asks for the CPU; without a card any other value raises.
``obs_*`` keys act as in ``train`` (obs/): ``obs_events_path`` writes the
run's timeline, which ``python -m lightgbm_tpu_torch obs summary|explain|
diff|trace|recompiles|roofline|serve|drift|incident|watch|prof|history|
trend`` reads (obs/query.py); ``tpu_profile_dir`` records a
torch.profiler trace of the whole training loop (obs/profile.py); ``obs
stragglers|merge`` read the per-rank timelines of a distributed run.
Not in the port yet, and refused naming its ROADMAP item: the ``lint``
subcommand.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np

from .basic import Booster
from .device import resolve_device
from .io import parser as _parser
from .io.dataset import TrainingData
from .metrics import create_metric
from .models import checkpoint as ckpt_mod
from .models.factory import create_boosting
from .objectives import create_objective
from .obs.profile import start_trace, stop_trace
from .utils.config import Config, key_alias_transform
from .utils.log import LightGBMError, Log


def parse_cli_params(argv: List[str]) -> Dict[str, str]:
    """config= file + k=v overrides; CLI wins (application.cpp:48-104)."""
    cli: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            Log.warning("Unknown argument: %s", arg)
            continue
        k, _, v = arg.partition("=")
        cli[k.strip()] = v.strip()
    params: Dict[str, str] = {}
    conf_path = cli.get("config") or cli.get("config_file")
    if conf_path:
        with open(conf_path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                params.setdefault(k.strip(), v.strip())
    params.update(cli)
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def _device(cfg: Config):
    """cpu when device_type (or device) says so, else the card."""
    return resolve_device("cpu" if cfg.device_type.lower() == "cpu"
                          else "cuda")


def _check_profilers(params: Dict[str, str], cfg: Config) -> None:
    if params.get("tpu_profile_dir") and cfg.obs_trace_iters:
        # torch.profiler runs one profiler at a time in a process
        raise LightGBMError("tpu_profile_dir and obs_trace_iters each open "
                            "a torch.profiler trace, and only one can run "
                            "at a time: set one of them")


def _metrics(cfg: Config, td: TrainingData) -> list:
    out = []
    for name in cfg.metrics():
        m = create_metric(name, cfg)
        if m is not None:
            m.init(td.metadata, td.num_data)
            out.append(m)
    return out


def run_train(cfg: Config, device) -> None:
    if not cfg.data:
        Log.fatal("No training data, application quit")
    # checkpoint resume, as engine.train: a compatible checkpoint in
    # checkpoint_dir seeds the model and only the remaining rounds run;
    # an explicit input_model wins.  Looked up before the data load
    # because continuing needs the raw rows kept.
    ck_dir = str(cfg.raw.get("checkpoint_dir", "") or "")
    ck_every = int(cfg.raw.get("checkpoint_every", 0) or 0)
    resume = None
    if ck_dir and not cfg.input_model:
        resume = ckpt_mod.load_checkpoint(ck_dir)
        if resume is not None:
            ckpt_mod.check_resumable(resume, dict(cfg.raw))
    base = None
    if cfg.input_model:
        with open(cfg.input_model) as f:
            base = f.read()
        Log.info("Continued training from %s", cfg.input_model)
    elif resume is not None:
        base = resume["model"]
    Log.info("Loading train data...")
    # continuing scores the loaded trees on the raw rows
    train_td = TrainingData.from_file(cfg.data, cfg,
                                      keep_raw=base is not None)
    if train_td._binned_reader is not None:
        Log.info("Train data is pre-binned (mmap-backed, %d shard(s), no "
                 "binning)", train_td._binned_reader.num_shards)
    objective = create_objective(cfg.objective, cfg)
    if objective is not None:
        objective.init(train_td.metadata, train_td.num_data, device)
    training_metrics = _metrics(cfg, train_td) if cfg.is_training_metric \
        else []
    booster = create_boosting(cfg.boosting_type, cfg, device, train_td,
                              objective, training_metrics)
    rounds_done = 0
    if base is not None:
        # the loaded trees come first; the scores start from their f64
        # host sums (GBDT.reset_training_data)
        booster.load_model_from_string(base)
        booster.reset_training_data(cfg, train_td, objective,
                                    training_metrics)
    if resume is not None:
        rounds_done = int(resume["iteration"])
        Log.info("Resuming from checkpoint %s: %d round(s) done, %d remain",
                 ck_dir, rounds_done, max(0, cfg.num_iterations - rounds_done))
    for i, vf in enumerate(cfg.valid_data or []):
        Log.info("Loading validation data %d...", i + 1)
        valid_td = TrainingData.from_file(vf, cfg, reference=train_td,
                                          keep_raw=base is not None)
        booster.add_valid_dataset(valid_td, _metrics(cfg, valid_td))
    Log.info("Started training...")
    saved = rounds_done
    # the reference's TIMETAG timers become a torch.profiler trace of the
    # training loop (Chrome trace format, Perfetto or chrome://tracing)
    profile_dir = str(cfg.raw.get("tpu_profile_dir", "") or "")
    if profile_dir:
        start_trace(profile_dir)
    finished = False
    try:
        for it in range(rounds_done, cfg.num_iterations):
            t0 = time.time()
            stop = booster.train_one_iter(None, None, True)
            Log.info("%f seconds elapsed, finished iteration %d",
                     time.time() - t0, it + 1)
            rounds_done = it + 1
            if cfg.snapshot_freq > 0 and (it + 1) % cfg.snapshot_freq == 0:
                _save(booster, "%s.snapshot_iter_%d"
                      % (cfg.output_model, it + 1))
            if ck_dir and ck_every > 0 and rounds_done % ck_every == 0:
                ckpt_mod.save_checkpoint(ck_dir, booster, rounds_done,
                                         dict(cfg.raw))
                saved = rounds_done
            if stop:
                break
        finished = True
    finally:
        if profile_dir:
            Log.info("torch.profiler trace -> %s", stop_trace())
        # run_end and the writer's flush, so a failed run still leaves a
        # readable timeline (status aborted)
        booster._obs.close(status="ok" if finished else "aborted")
    if booster._obs.enabled and booster._obs.events_path:
        Log.info("Telemetry timeline -> %s (query with `python -m "
                 "lightgbm_tpu_torch obs summary %s`)",
                 booster._obs.events_path, booster._obs.events_path)
    if cfg.obs_metrics_path:
        Log.info("Metrics export -> %s", cfg.obs_metrics_path)
    # and at the end, so that a later run with more rounds resumes here
    if ck_dir and ck_every > 0 and rounds_done != saved:
        ckpt_mod.save_checkpoint(ck_dir, booster, rounds_done, dict(cfg.raw))
    _save(booster, cfg.output_model)
    Log.info("Finished training")


def _save(gbdt, path: str) -> None:
    with open(path, "w") as f:
        f.write(gbdt.save_model_to_string())


def run_predict(cfg: Config, device) -> None:
    if not cfg.data:
        Log.fatal("No prediction data, application quit")
    with open(cfg.input_model) as f:
        model_str = f.read()
    booster = Booster(params=dict(cfg.raw), model_str=model_str,
                      device=device)
    parsed = _parser.parse_file(cfg.data, has_header=cfg.has_header)
    out = booster.predict(parsed.features,
                          num_iteration=cfg.num_iteration_predict,
                          raw_score=cfg.is_predict_raw_score,
                          pred_leaf=cfg.is_predict_leaf_index)
    write_predictions(np.asarray(out), cfg.output_result)
    Log.info("Finished prediction, results saved to %s", cfg.output_result)


def write_predictions(out: np.ndarray, path: str) -> None:
    """One line a row, ``%.9g``, tab-separated for K > 1."""
    with open(path, "w") as f:
        if out.ndim == 1:
            for v in out:
                f.write("%.9g\n" % v)
        else:
            for row in out:
                f.write("\t".join("%.9g" % v for v in row) + "\n")


def run_convert_model(cfg: Config) -> None:
    """Model -> C++ if-else source (GBDT::SaveModelToIfElse path,
    application.cpp ConvertModel), on the host."""
    from .convert_model import model_to_cpp
    with open(cfg.input_model) as f:
        booster = Booster(model_str=f.read(), device="cpu")
    with open(cfg.convert_model, "w") as f:
        f.write(model_to_cpp(booster._gbdt))
    Log.info("Model converted to %s", cfg.convert_model)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "obs":
        # timeline queries: python -m lightgbm_tpu_torch obs
        # summary|explain|diff|trace ...
        from .obs.query import main as obs_main
        return obs_main(argv[1:])
    if argv and argv[0] == "lint":
        # the static analyzer: python -m lightgbm_tpu_torch lint
        # [paths] [--check] [--json] [--baseline F] [--write-baseline F]
        # [--rules]
        from .analysis.cli import main as lint_main
        return lint_main(argv[1:])
    params = key_alias_transform(parse_cli_params(argv),
                                 raise_unknown=False)
    cfg = Config(params)
    _check_profilers(params, cfg)
    task = params.get("task", "train")
    if task == "train":
        run_train(cfg, _device(cfg))
    elif task in ("predict", "prediction", "test"):
        run_predict(cfg, _device(cfg))
    elif task == "convert_model":
        run_convert_model(cfg)
    else:
        Log.fatal("Unknown task: %s", task)
    return 0


def console_entry() -> None:
    """Console-script entry."""
    sys.exit(main())


if __name__ == "__main__":
    console_entry()
