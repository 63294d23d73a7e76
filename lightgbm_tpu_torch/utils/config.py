"""Parameter system: canonical keys, aliases, typed defaults, conflict checks.

Parity target: include/LightGBM/config.h:87-489 and src/io/config.cpp.  The
parameter names and alias table are the de-facto API of the reference and are
kept verbatim.  New device type ``tpu`` joins ``cpu``/``gpu`` (the whole point
of this framework); unknown parameters raise, as in
``ParameterAlias::KeyAliasTransform`` (config.h:479).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .log import Log

# alias -> canonical   (config.h:362-450)
ALIAS_TABLE: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "random_seed": "seed",
    "num_thread": "num_threads",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "tranining_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    # multi-host pod bootstrap (parallel/comm.py distributed_init) and
    # elastic checkpoint/resume (models/checkpoint.py)
    "coordinator": "dist_coordinator",
    "coordinator_address": "dist_coordinator",
    "dist_world_size": "dist_num_processes",
    "dist_rank": "dist_process_id",
    "checkpoint_freq": "checkpoint_every",
    "checkpoint_path": "checkpoint_dir",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    # out-of-core streaming ingest (io/streaming.py + io/binned_format.py)
    "stream_chunk_rows": "ooc_chunk_rows",
    "ooc_chunk": "ooc_chunk_rows",
    "stream_workers": "ooc_workers",
    "binning_workers": "ooc_workers",
    "save_binned": "ooc_binned_dir",
    "save_binned_dir": "ooc_binned_dir",
    "binned_dir": "ooc_binned_dir",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "unbalanced_sets": "is_unbalance",
    "bagging_fraction_seed": "bagging_seed",
    "obs_events_file": "obs_events_path",
    "obs_events": "obs_events_path",
    "obs_profile_iters": "obs_trace_iters",
    "obs_profile_dir": "obs_trace_dir",
    "obs_memory_freq": "obs_memory_every",
    "obs_health_mode": "obs_health",
    "obs_health_freq": "obs_health_every",
    "obs_metrics_file": "obs_metrics_path",
    "obs_metrics": "obs_metrics_path",
    "obs_metrics_freq": "obs_metrics_every",
    "obs_compile_attr": "obs_compile",
    "obs_recompile_attr": "obs_compile",
    "obs_straggler_freq": "obs_straggler_every",
    "obs_straggler_skew": "obs_straggler_warn_skew",
    "obs_watchdog": "obs_watchdog_secs",
    "obs_events_fsync": "obs_fsync",
    "obs_ring_events": "obs_flight_events",
    "obs_audit": "obs_split_audit",
    "obs_audit_splits": "obs_split_audit",
    "obs_importance_freq": "obs_importance_every",
    "obs_importance_k": "obs_importance_topk",
    "obs_profile_data": "obs_data_profile",
    "obs_dataset_profile": "obs_data_profile",
    "obs_ledger": "obs_ledger_dir",
    "ledger_dir": "obs_ledger_dir",
    "ledger_suite": "obs_ledger_suite",
    "ledger_window": "obs_ledger_window",
    "obs_ledger_n": "obs_ledger_window",
    "obs_utilization_freq": "obs_utilization_every",
    "obs_roofline_every": "obs_utilization_every",
    "obs_roofline_peaks_path": "obs_roofline_peaks",
    "obs_http": "obs_http_port",
    "obs_port": "obs_http_port",
    "obs_http_host": "obs_http_addr",
    "obs_http_address": "obs_http_addr",
    "obs_drift_rows": "obs_drift_every",
    "obs_drift_freq": "obs_drift_every",
    "obs_drift_window_rows": "obs_drift_window",
    "obs_drift_psi_threshold": "obs_drift_psi",
    "obs_drift_threshold": "obs_drift_psi",
    "obs_fingerprint": "obs_drift_fingerprint",
    "obs_drift_k": "obs_drift_topk",
    "obs_incidents": "obs_incident",
    "obs_incident_window": "obs_incident_window_s",
    "obs_incident_path": "obs_incident_dir",
    "obs_profile_hz": "obs_prof_hz",
    "obs_prof_rate": "obs_prof_hz",
    "obs_prof_window": "obs_prof_window_s",
    "obs_prof_top_k": "obs_prof_topk",
    "serve_microbatch_max": "serve_max_batch",
    "serve_deadline_ms": "serve_max_delay_ms",
    "serve_min_bucket": "serve_bucket_min",
    "serve_donate_buffers": "serve_donate",
    "serve_batch_events": "serve_batch_event_every",
    "serve_max_queue": "serve_queue_limit",
    "serve_queue_max": "serve_queue_limit",
    "serve_timeout_ms": "serve_request_deadline_ms",
    "serve_request_events": "serve_request_event_every",
    "serve_slo_p99": "serve_slo_p99_ms",
    "serve_slo_window": "serve_slo_window_s",
    "serve_slo_snapshot_every": "serve_slo_every_s",
    "autotune": "tpu_autotune",
    "autotune_mode": "tpu_autotune",
    "autotune_cache": "tpu_autotune_cache",
    "autotune_cache_path": "tpu_autotune_cache",
    "autotune_waves": "tpu_autotune_waves",
    "fused_iter": "tpu_fused_iter",
}

# canonical parameters accepted without aliasing (config.h:451-478), plus the
# handful the reference reads outside the set (task/device/metric aliases) and
# tpu-specific additions.
PARAMETER_SET = {
    "config", "config_file", "task", "device", "device_type",
    "num_threads", "seed", "boosting_type", "objective", "data",
    "output_model", "input_model", "output_result", "valid_data",
    "is_enable_sparse", "is_pre_partition", "is_training_metric",
    "ndcg_eval_at", "min_data_in_leaf", "min_sum_hessian_in_leaf",
    "num_leaves", "feature_fraction", "num_iterations",
    "bagging_fraction", "bagging_freq", "learning_rate", "tree_learner",
    "num_machines", "local_listen_port", "use_two_round_loading",
    "machine_list_file", "is_save_binary_file", "early_stopping_round",
    "verbose", "has_header", "label_column", "weight_column", "group_column",
    "ignore_column", "categorical_column", "is_predict_raw_score",
    "is_predict_leaf_index", "min_gain_to_split", "top_k",
    "lambda_l1", "lambda_l2", "num_class", "is_unbalance",
    "max_depth", "subsample_for_bin", "max_bin", "bagging_seed",
    "drop_rate", "skip_drop", "max_drop", "uniform_drop",
    "xgboost_dart_mode", "drop_seed", "top_rate", "other_rate",
    "min_data_in_bin", "data_random_seed", "bin_construct_sample_cnt",
    "num_iteration_predict", "pred_early_stop", "pred_early_stop_freq",
    "pred_early_stop_margin", "use_missing", "sigmoid", "huber_delta",
    "fair_c", "poission_max_delta_step", "scale_pos_weight",
    "boost_from_average", "max_position", "label_gain",
    "metric", "metric_freq", "time_out",
    "gpu_platform_id", "gpu_device_id", "gpu_use_dp",
    "convert_model", "convert_model_language",
    "feature_fraction_seed", "enable_bundle", "data_filename",
    "valid_data_filenames", "snapshot_freq", "sparse_threshold",
    "enable_load_from_binary_file", "max_conflict_rate",
    "ooc_chunk_rows", "ooc_workers", "ooc_binned_dir",
    # multi-host pod bootstrap + elastic checkpoint/resume
    "dist_coordinator", "dist_num_processes", "dist_process_id",
    "checkpoint_every", "checkpoint_dir",
    "poisson_max_delta_step", "gaussian_eta", "histogram_pool_size",
    "output_freq", "is_provide_training_metric", "machine_list_filename",
    "capacity",
    # tpu-native additions
    "tpu_use_dp", "tpu_histogram_mode", "tpu_profile_dir", "feature_name",
    "tpu_growth", "tpu_wave_width", "tpu_bin_pack", "tpu_wave_chunk",
    "tpu_sparse", "tpu_wave_order", "tpu_predict", "tpu_wave_lookup",
    "tpu_sparse_kernel", "tpu_hist_precision", "tpu_score_update",
    "tpu_wave_compact",
    # measured kernel autotuner (ops/autotune.py)
    "tpu_autotune", "tpu_autotune_cache", "tpu_autotune_waves",
    # fused boosting iteration (ops/fused_iter.py)
    "tpu_fused_iter", "tpu_pallas_interpret",
    # observability (lightgbm_tpu/obs/)
    "obs_events_path", "obs_timing", "obs_memory_every",
    "obs_trace_iters", "obs_trace_dir", "obs_flush_every",
    "obs_health", "obs_health_every", "obs_health_divergence",
    "obs_health_plateau", "obs_health_mem_frac",
    "obs_metrics_path", "obs_metrics_every",
    "obs_compile", "obs_straggler_every", "obs_straggler_warn_skew",
    "obs_watchdog_secs", "obs_fsync", "obs_flight_events",
    "obs_split_audit", "obs_importance_every", "obs_importance_topk",
    "obs_data_profile",
    # cross-run performance ledger (obs/ledger.py)
    "obs_ledger_dir", "obs_ledger_suite", "obs_ledger_window",
    # roofline attribution (obs/roofline.py)
    "obs_utilization_every", "obs_roofline_peaks",
    # live telemetry plane (obs/live.py)
    "obs_http_port", "obs_http_addr",
    # drift & online model-quality monitoring (obs/drift.py)
    "obs_drift_every", "obs_drift_window", "obs_drift_psi",
    "obs_drift_fingerprint", "obs_drift_topk", "obs_drift_min_labels",
    # incident engine (obs/incident.py)
    "obs_incident", "obs_incident_window_s", "obs_incident_dir",
    "obs_incident_trace",
    # continuous host profiler (obs/prof.py)
    "obs_prof_hz", "obs_prof_window_s", "obs_prof_topk",
    # serving tier (lightgbm_tpu/serve/)
    "serve_max_batch", "serve_max_delay_ms", "serve_bucket_min",
    "serve_donate", "serve_batch_event_every",
    # serving observability & overload protection (obs/serve.py)
    "serve_queue_limit", "serve_request_deadline_ms",
    "serve_request_event_every", "serve_slo_p99_ms", "serve_slo_qps",
    "serve_slo_window_s", "serve_slo_every_s",
}

_TRUE_SET = {"1", "true", "yes", "on", "+"}
_FALSE_SET = {"0", "false", "no", "off", "-"}


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in _TRUE_SET:
        return True
    if s in _FALSE_SET:
        return False
    Log.fatal("Parameter: value %s cannot be parsed as bool", v)


def _to_int(v: Any) -> int:
    if isinstance(v, bool):
        return int(v)
    try:
        return int(v)
    except (TypeError, ValueError):
        return int(float(v))


def _to_double_vec(v: Any) -> List[float]:
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    s = str(v).strip()
    if not s:
        return []
    return [float(x) for x in s.replace(",", " ").split()]


def _to_int_vec(v: Any) -> List[int]:
    return [int(round(x)) for x in _to_double_vec(v)]


def param_dict_to_str(data: Optional[dict]) -> str:
    """Serialize params the way python-package/basic.py:124 does."""
    if not data:
        return ""
    pairs = []
    for key, val in data.items():
        if isinstance(val, (list, tuple, set)):
            pairs.append(str(key) + "=" + ",".join(map(str, val)))
        elif isinstance(val, (str, int, float, bool)):
            pairs.append(str(key) + "=" + str(val))
        elif val is not None:
            Log.fatal("Unknown type of parameter:%s, got:%s", key, type(val).__name__)
    return " ".join(pairs)


def key_alias_transform(params: Dict[str, Any], raise_unknown: bool = False) -> Dict[str, Any]:
    """Canonicalise keys via the alias table (config.h:479-489 semantics).

    A canonical key present in the input wins over any alias of it.  Unknown
    keys are warned about (the CLI path raises, matching ``Log::Fatal``).
    """
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for key, val in params.items():
        if key in ALIAS_TABLE:
            aliased.setdefault(ALIAS_TABLE[key], val)
        else:
            if key not in PARAMETER_SET:
                if raise_unknown:
                    Log.fatal("Unknown parameter: %s", key)
                Log.warning("Unknown parameter: %s", key)
            out[key] = val
    for key, val in aliased.items():
        out.setdefault(key, val)
    return out


class Config:
    """Typed view over a canonical parameter dict.

    Flat rather than the reference's nested sub-config structs — every field
    of IOConfig/ObjectiveConfig/MetricConfig/TreeConfig/BoostingConfig/
    NetworkConfig/OverallConfig (config.h:87-354) is present with the same
    default.
    """

    _FIELDS = {
        # OverallConfig
        "task": ("str", "train"),
        "seed": ("int", 0),
        "num_threads": ("int", 0),
        "boosting_type": ("str", "gbdt"),
        "objective": ("str", "regression"),
        "metric": ("strvec", None),            # resolved by boosting layer
        "convert_model_language": ("str", ""),
        # IOConfig
        "max_bin": ("int", 255),
        "num_class": ("int", 1),
        "data_random_seed": ("int", 1),
        "data": ("str", ""),
        "valid_data": ("strvec", None),
        "snapshot_freq": ("int", 100),
        "output_model": ("str", "LightGBM_model.txt"),
        "output_result": ("str", "LightGBM_predict_result.txt"),
        "convert_model": ("str", "gbdt_prediction.cpp"),
        "input_model": ("str", ""),
        "verbose": ("int", 1),
        "num_iteration_predict": ("int", -1),
        "is_pre_partition": ("bool", False),
        "is_enable_sparse": ("bool", True),
        "sparse_threshold": ("float", 0.8),
        "use_two_round_loading": ("bool", False),
        "is_save_binary_file": ("bool", False),
        "enable_load_from_binary_file": ("bool", True),
        "bin_construct_sample_cnt": ("int", 200000),
        # out-of-core streaming ingest (io/streaming.py): row-chunk size
        # for array/sparse sources, worker-pool width (0 = all cores),
        # and an optional directory to persist the pre-binned mmap format
        # (io/binned_format.py) during construction
        "ooc_chunk_rows": ("int", 262144),
        "ooc_workers": ("int", 0),
        "ooc_binned_dir": ("str", ""),
        "is_predict_leaf_index": ("bool", False),
        "is_predict_raw_score": ("bool", False),
        "min_data_in_leaf": ("int", 20),
        "min_data_in_bin": ("int", 5),
        "max_conflict_rate": ("float", 0.0),
        "enable_bundle": ("bool", True),
        "has_header": ("bool", False),
        "label_column": ("str", ""),
        "weight_column": ("str", ""),
        "group_column": ("str", ""),
        "ignore_column": ("str", ""),
        "categorical_column": ("str", ""),
        "device_type": ("str", "tpu"),
        "pred_early_stop": ("bool", False),
        "pred_early_stop_freq": ("int", 10),
        "pred_early_stop_margin": ("float", 10.0),
        # ObjectiveConfig
        "sigmoid": ("float", 1.0),
        "huber_delta": ("float", 1.0),
        "fair_c": ("float", 1.0),
        "gaussian_eta": ("float", 1.0),
        "poisson_max_delta_step": ("float", 0.7),
        "label_gain": ("floatvec", None),
        "max_position": ("int", 20),
        "is_unbalance": ("bool", False),
        "scale_pos_weight": ("float", 1.0),
        # MetricConfig
        "ndcg_eval_at": ("intvec", None),
        "metric_freq": ("int", 1),
        # TreeConfig
        "min_sum_hessian_in_leaf": ("float", 1e-3),
        "lambda_l1": ("float", 0.0),
        "lambda_l2": ("float", 0.0),
        "min_gain_to_split": ("float", 0.0),
        "num_leaves": ("int", 31),
        "feature_fraction_seed": ("int", 2),
        "feature_fraction": ("float", 1.0),
        "histogram_pool_size": ("float", -1.0),
        "max_depth": ("int", -1),
        "top_k": ("int", 20),
        "gpu_platform_id": ("int", -1),
        "gpu_device_id": ("int", -1),
        "gpu_use_dp": ("bool", False),
        "use_missing": ("bool", True),
        # BoostingConfig
        "output_freq": ("int", 1),
        "is_training_metric": ("bool", False),
        "num_iterations": ("int", 100),
        "learning_rate": ("float", 0.1),
        "bagging_fraction": ("float", 1.0),
        "bagging_seed": ("int", 3),
        "bagging_freq": ("int", 0),
        "early_stopping_round": ("int", 0),
        "drop_rate": ("float", 0.1),
        "max_drop": ("int", 50),
        "skip_drop": ("float", 0.5),
        "xgboost_dart_mode": ("bool", False),
        "uniform_drop": ("bool", False),
        "drop_seed": ("int", 4),
        "top_rate": ("float", 0.2),
        "other_rate": ("float", 0.1),
        "capacity": ("float", 50.0),
        "boost_from_average": ("bool", True),
        "tree_learner": ("str", "serial"),
        # NetworkConfig
        "num_machines": ("int", 1),
        "local_listen_port": ("int", 12400),
        "time_out": ("int", 120),
        "machine_list_file": ("str", ""),
        # multi-host pod bootstrap (parallel/comm.py distributed_init):
        # coordinator "host:port" ("" = env autodetect via
        # JAX_COORDINATOR_ADDRESS), process count (0 = autodetect) and
        # this process's id (-1 = autodetect)
        "dist_coordinator": ("str", ""),
        "dist_num_processes": ("int", 0),
        "dist_process_id": ("int", -1),
        # elastic fault tolerance (models/checkpoint.py): save a compact
        # booster checkpoint every N iterations (0 = off) into
        # checkpoint_dir so a shrunk mesh can resume mid-train
        "checkpoint_every": ("int", 0),
        "checkpoint_dir": ("str", ""),
        # tpu-native additions
        "tpu_use_dp": ("bool", False),
        # 'auto' | 'true' | 'false' — rank-encoded device bulk prediction
        # (ops/predict.py): f64-exact routing as int32 compares on TPU.
        # auto = device for >=100k-row batches on TPU, host otherwise.
        "tpu_predict": ("str", "auto"),
        # 'auto' | 'scatter' | 'onehot' | 'pallas' | 'pallas_t' |
        # 'pallas_ct' — histogram kernel ('pallas' = exact-engine
        # per-leaf kernel, 'pallas_t' = wave kernel with MXU-native
        # transposed operands, 'pallas_ct' = fused partition+histogram
        # wave kernel, compact split table, one read of X_t per wave).
        # auto, on TPU when the wave engine runs it (f32, dense,
        # serial/data learner): pallas_ct for narrow shapes
        # (ncols * bin_pad <= 2048 — measured winner at 10.5M x 28 and
        # 1M x 28, r4), pallas_t for wider VMEM-feasible shapes; else
        # onehot on TPU, scatter elsewhere.  (pallas_f/pallas_ft were
        # deleted in r4: lost every on-chip A/B, padded-operand OOM
        # liability — tools/AB_RESULTS.md.)
        "tpu_histogram_mode": ("str", "auto"),
        # 'auto' | 'exact' | 'wave' — growth schedule (ops/wave.py):
        # 'exact' is the reference's one-split-at-a-time leaf-wise order;
        # 'wave' batches the top-W pending splits per sweep for the MXU.
        # auto -> wave on TPU, exact elsewhere.
        "tpu_growth": ("str", "auto"),
        # W in 'wave' growth: splits the top-W pending leaves per sweep
        # (same greedy frontier as leaf-wise, batched; quality parity in
        # tests/test_wave.py).  -1 = auto, scaled to num_leaves (measured
        # on v5e: W=16 fastest at 63 leaves, W=32 at 255); set 1 to
        # reproduce the reference's exact split sequence.
        "tpu_wave_width": ("int", -1),
        # 'auto' | 'batched' | 'exact' — wave COMMIT ORDER
        # (ops/wave.py).  'batched' commits all W top-gain splits per
        # wave (the greedy frontier approximates the leaf-wise ORDER).
        # 'exact' builds the same W candidate histograms per wave but
        # commits only the prefix the reference's leaf-wise order would
        # have produced (rolling the rest back with a leaf-id remap) —
        # trees match tpu_wave_width=1 and tpu_growth=exact to the byte,
        # on every dataflow (pallas_ct, pallas_t, pallas, sparse), fused
        # or staged.  auto -> exact for order-sensitive configs
        # (lambdarank, DART, GOSS, InfiniteBoost), batched otherwise.
        "tpu_wave_order": ("str", "auto"),
        # 'auto' | 'onehot' | 'compact' | 'gather' — how the wave
        # partition scan looks up each row's pending split: 'onehot'
        # contracts a (chunk, num_leaves) leaf one-hot against the
        # (L, 10) split table on the MXU; 'compact' matches rows against
        # only the W wave parents (<=1 match per row, so the masked sum
        # is exact) — W/L of the one-hot footprint; 'gather' indexes the
        # table directly.  auto -> compact on TPU (measured +12% over
        # onehot-lookup on v5e at the flagship recipe), onehot elsewhere.
        "tpu_wave_lookup": ("str", "auto"),
        # 'auto' | 'hilo' | 'bf16' — MXU product precision of the Pallas
        # wave histogram kernels.  'hilo' (exact bf16 hi+lo split, two
        # dots, ~2^-17 relative products) is the quality-first default;
        # 'bf16' (single round-to-nearest bf16 term, ~2^-9 products,
        # f32 accumulation) HALVES the kernel's MXU work — the analog of
        # the reference GPU's default single-precision histograms
        # (docs/GPU-Performance.md:127-130, gpu_use_dp=false).  Split
        # ROUTING is unaffected (exact f32 compares) — only histogram
        # sums, and through them split choices, can drift.  auto = bf16
        # where the Pallas wave kernels run under single-chip wave
        # growth (promoted round 5: 1.63x at the 10.5M flagship, AUC
        # within 1.0e-4 — tools/BENCH_SUITE.md higgs_bf16); exact
        # growth, data-parallel execution, and every non-pallas engine
        # stay hilo.  Set 'hilo' to force the exact split everywhere.
        "tpu_hist_precision": ("str", "auto"),
        # row-chunk size of the wave engine's fused partition+histogram
        # sweep; smaller chunks shrink the (chunk, F*B) one-hot tile
        # (VMEM-residency vs scan-overhead tradeoff on TPU; engine
        # minimum 256 — smaller values are clamped with a warning)
        "tpu_wave_chunk": ("int", 16384),
        # 'auto' | 'true' | 'false' — 4-bit bin packing (ops/pack.py, the
        # dense_nbits_bin.hpp:37 analog): when every device column holds at
        # most 16 bins (max_bin<=15 plus the reserved zero/missing bin),
        # two columns share a byte in HBM and the wave engine unpacks per
        # chunk.  auto = pack whenever eligible.
        "tpu_bin_pack": ("str", "auto"),
        # device-side sparse bin storage (ops/sparse_store.py, SparseBin
        # analog): per-leaf histograms become one segment_sum over the
        # nonzero entries instead of an O(N*F) dense pass.  Exact engine
        # under the serial and data-parallel learners; default dense.
        "tpu_sparse": ("bool", False),
        # entry-chunk MXU store (ops/sparse_mxu.py): with tpu_sparse=true,
        # replace the segment_sum coordinate store with fixed-size
        # per-column entry chunks whose histograms are small MXU
        # contractions inside a Pallas kernel (the OrderedSparseBin
        # economics, TPU form).  Forces wave growth; serial learner only.
        "tpu_sparse_kernel": ("bool", False),
        # 'auto' | 'gather' | 'pallas' — the train-side score update
        # (score += leaf_value[leaf_id]).  'gather' = XLA small-table
        # gather; 'pallas' = compare-select kernel (ops/predict.py,
        # bit-equal, measured faster at the 10.5M flagship: 1.45 vs
        # 1.30 it/s with EXACTLY equal AUC — tools/BENCH_SUITE.md
        # higgs_su).  auto = pallas (promoted round 5); the dispatch
        # falls back to the gather off-TPU, above 512 leaves, or on
        # f64 scores (tpu_use_dp).
        "tpu_score_update": ("str", "auto"),
        # spectator-row compaction for the transposed wave kernels
        # (tpu_histogram_mode=pallas_ct/pallas_t): late waves touch only the rows
        # whose leaf is still splitting (~35% of row work at the flagship
        # recipe is rows whose leaf is final — measured frontier
        # occupancy, ROADMAP.md r4), so the wave gathers the active rows
        # into a capacity tier (1/2, 1/4, 1/8 of N) and runs the kernel
        # on the compacted slab.  Split structure is exact (spectator
        # rows route nowhere and carry zero histogram weight); float
        # fields can drift by f32 ulps at multi-tile N (tile-boundary
        # reassociation) — pinned vs the full-N pass in
        # tests/test_wave_compact.py.  Off until the on-chip A/B lands.
        "tpu_wave_compact": ("bool", False),
        # 'off' | 'prior' | 'measure' | 'force' — the measured kernel
        # autotuner (ops/autotune.py, docs/Autotuning.md).  off = the
        # heuristic prior only (bit-identical to the legacy inline
        # selection; the CPU-CI default).  prior = adopt a cached
        # winner when one exists, never probe.  measure = on cache miss
        # microbench the 3-5 candidate (kernel, W, precision,
        # compaction) cells for the shape bucket on-device and persist
        # the winner.  force = always re-probe, overwriting the cache.
        "tpu_autotune": ("str", "off"),
        # autotune cache file; empty = autotune_cache.json next to the
        # XLA compile cache (LGBM_TPU_COMPILE_CACHE, utils/common.py)
        "tpu_autotune_cache": ("str", ""),
        # timed waves per probed cell (compile + one warmup wave are
        # always excluded from the timing window)
        "tpu_autotune_waves": ("int", 3),
        # 'auto' | 'on' | 'off' — the fused boosting iteration
        # (ops/fused_iter.py): gradients, growth (wave or exact) and the
        # score update as a few CUDA graph replays a tree, with one host
        # read a tree under batched waves (and one a block of waves or
        # splits past the tree graph's), instead of the staged chain's
        # launches from Python and read a wave or a batch of splits.
        # auto = fuse when eligible and training runs on CUDA.  on = fuse
        # when eligible, on the CPU too (warns and stays staged when
        # not).  off = always the staged chain.  Fused and staged
        # produce byte-identical models (tests/test_torch_fused_iter.py).
        "tpu_fused_iter": ("str", "auto"),
        # run the Pallas wave kernels through the interpreter on CPU
        # (tests/CI only): exercises the real kernel bodies — tiling,
        # accumulator layout, reduction order — without a TPU, so
        # fused-vs-staged parity is testable end-to-end.  Ignored (with
        # a warning) on TPU.
        "tpu_pallas_interpret": ("bool", False),
        # observability (lightgbm_tpu/obs/): setting any of
        # obs_events_path / obs_trace_iters / obs_memory_every turns the
        # run observer on; all-defaults leaves the NULL observer in place
        # (no fencing, no event objects on the hot path).
        # JSONL event timeline destination (docs/Observability.md);
        # append-mode, one run header + per-iteration records per run.
        "obs_events_path": ("str", ""),
        # 'auto' | 'phase' | 'iter' | 'off' — fencing policy for the
        # phase timers.  'phase' fences every phase boundary with
        # jax.block_until_ready (device-accurate per-phase times; breaks
        # async pipelining).  'iter' fences once per iteration (accurate
        # totals, dispatch-only phases — the bench protocol).  'off'
        # never fences (dispatch cost only).  auto = phase.
        "obs_timing": ("str", "auto"),
        # emit a per-device memory_stats() snapshot every N iterations
        # (0 = off; CPU backend reports device identity only)
        "obs_memory_every": ("int", 0),
        # 'a:b' — open a jax.profiler trace window at iteration a and
        # close it after iteration b-1 (python-range semantics); captures
        # a perfetto trace of exactly the steady-state iterations.
        # Requires obs_trace_dir.
        "obs_trace_iters": ("str", ""),
        # destination directory of the obs_trace_iters profiler window
        "obs_trace_dir": ("str", ""),
        # flush the JSONL writer every N events (crash-tolerant timeline)
        "obs_flush_every": ("int", 16),
        # training health monitors (lightgbm_tpu/obs/health.py):
        # 'off' | 'warn' | 'fatal'.  warn logs + emits a `health` event;
        # fatal additionally flushes the timeline and raises
        # LightGBMError, aborting the run.  Non-default turns the
        # observer on even without obs_events_path (in-memory timeline).
        "obs_health": ("str", "off"),
        # run the health checks every N iterations
        "obs_health_every": ("int", 1),
        # loss-divergence trigger: gradient magnitude above
        # divergence x EMA for 2 consecutive checks (<=0 disables)
        "obs_health_divergence": ("float", 3.0),
        # plateau trigger after N consecutive near-flat checks
        # (0 = off; plateau warns but never escalates to fatal)
        "obs_health_plateau": ("int", 0),
        # memory watermark: warn/fatal when any device's bytes_in_use
        # exceeds this fraction of bytes_limit (backends with byte
        # counters only; <=0 disables)
        "obs_health_mem_frac": ("float", 0.9),
        # write the metrics-registry export at run end: Prometheus
        # textfile format for .prom/.txt suffixes, JSON otherwise
        "obs_metrics_path": ("str", ""),
        # embed a registry snapshot (`metrics` event) in the timeline
        # every N iterations (0 = only the final snapshot at run end)
        "obs_metrics_every": ("int", 0),
        # XLA compile-cache introspection (lightgbm_tpu/obs/compile.py):
        # track per-entry compile counts and the arg shape/dtype/donation
        # signature of every recompile, diffed so the `compile_attr`
        # event names the changed axis, plus cost_analysis() /
        # memory_analysis() estimates.  Turns the observer on.
        "obs_compile": ("bool", False),
        # sample per-shard arrival skew of the distributed learners
        # every N iterations (obs/straggler.py; each sample fences, so
        # keep the cadence coarse).  0 = off.  No-op on single device.
        "obs_straggler_every": ("int", 0),
        # warn (through the obs_health channel) when a straggler
        # sample's skew — (max-median)/total per-shard wait — exceeds
        # this fraction
        "obs_straggler_warn_skew": ("float", 0.5),
        # hang watchdog (obs/watchdog.py): dump a flight record
        # (<events_path>.flight.json — event ring buffer, all thread
        # stacks, device memory, metrics snapshot) when no iteration or
        # host-collective progress lands within this many seconds.
        # 0 = off.  The watchdog only observes; it never kills the run.
        "obs_watchdog_secs": ("float", 0.0),
        # os.fsync the timeline shard on run_end (and flight records
        # always fsync) — survives a host dying mid-close at the cost
        # of one sync per run
        "obs_fsync": ("bool", False),
        # size of the in-memory event ring buffer the flight record
        # snapshots (last N events this rank emitted)
        "obs_flight_events": ("int", 256),
        # split audit trail (obs/model.py): emit a `split_audit` event
        # per tree recording every realized split's feature, bin/real
        # threshold, gain, child counts, and the runner-up feature +
        # gain margin from the split search.  Turns the observer on.
        "obs_split_audit": ("bool", False),
        # emit a top-k sparse `importance` event (cumulative split/gain
        # feature importance) every N iterations (0 = off).  Turns the
        # observer on; read back via Booster.importance_history() /
        # `obs explain` / plotting.plot_importance.
        "obs_importance_every": ("int", 0),
        # how many features each `importance` event keeps (top-k by
        # gain, ties to the smaller feature index)
        "obs_importance_topk": ("int", 20),
        # emit a `data_profile` event at training start (per-feature
        # missing rate, bin-occupancy entropy, constant / near-constant
        # / high-cardinality-categorical flags, label balance) whenever
        # the observer is enabled; degenerate findings route through the
        # obs_health channel (warn logs, fatal aborts naming the
        # feature).  Does NOT enable the observer by itself.
        "obs_data_profile": ("bool", True),
        # cross-run performance ledger (obs/ledger.py): directory the
        # observer ingests finished runs into on clean close (append-only
        # JSONL index + per-run records; crash-safe tmp+replace writes).
        # Empty = no automatic ingestion.  bench.py points this at
        # LGBM_TPU_LEDGER (default /tmp/lgbm_tpu_ledger) so every bench
        # run lands in history; `obs trend --check` and bench_compare
        # --baseline rolling gate against it.  Turns the observer on.
        "obs_ledger_dir": ("str", ""),
        # ledger suite label of this run — the coarse comparability key
        # rolling baselines group by (e.g. 'bench', 'serve',
        # 'suite_tall').  Empty = the run_header context tool name.
        "obs_ledger_suite": ("str", ""),
        # rolling-baseline window: median/MAD statistics cover the last
        # N comparable clean runs of the same (suite, shape, device) cell
        "obs_ledger_window": ("int", 8),
        # roofline attribution (obs/roofline.py): emit a `utilization`
        # rollup event every N iterations — exec-weighted achieved/peak
        # FLOP and HBM-bandwidth fractions of every timed entry against
        # the device-peak registry, dominant bound, headroom seconds.
        # Implies obs_compile (the join needs cost estimates).  0 = off.
        # Turns the observer on.
        "obs_utilization_every": ("int", 0),
        # JSON file of device-peak overrides for the roofline layer
        # ({device_kind: {flops_f32, flops_bf16, hbm_bytes_per_s,
        # ici_bytes_per_s, vmem_bytes}}), merged over the built-in
        # table.  Empty = built-in peaks (unknown kinds fall back to a
        # labelled CPU profile).
        "obs_roofline_peaks": ("str", ""),
        # live telemetry plane (obs/live.py): HTTP port of the in-run
        # scrape server (/metrics /healthz /statusz /events).  -1 = off
        # (the default), 0 = bind an ephemeral port (reported via
        # Booster telemetry and the run log), >0 = that port.  Turns
        # the observer on.
        "obs_http_port": ("int", -1),
        # bind address of the live plane.  Loopback by default — the
        # endpoints expose run params and provenance, so routing them
        # off-host (e.g. 0.0.0.0 on a pod) is a deliberate choice.
        "obs_http_addr": ("str", "127.0.0.1"),
        # drift & online model-quality monitoring (obs/drift.py):
        # evaluate serving traffic against the training-time
        # fingerprint every N submitted rows — per-feature + score
        # PSI/KS, `drift` events, lgbm_drift_psi gauges, obs_health
        # alerts.  0 = off (the default; fingerprints still persist so
        # any later serving process can turn it on).
        "obs_drift_every": ("int", 0),
        # rolling-window size in rows: histograms reset once this many
        # rows accumulated, so stale traffic cannot mask fresh drift
        "obs_drift_window": ("int", 8192),
        # PSI alert threshold (fires at >=, clears at half): 0.1-0.25
        # is the conventional 'moderate shift' band — 0.2 pages on the
        # upper half of it
        "obs_drift_psi": ("float", 0.2),
        # capture the per-feature binned histograms of the training
        # sample and persist them with the model text / binned dataset
        # dir as the serving-time drift reference.  On by default: the
        # cost is one bincount per feature over the binning sample the
        # data-quality profile already scans.
        "obs_drift_fingerprint": ("bool", True),
        # top-k most-divergent features carried in each drift event and
        # exported as lgbm_drift_psi{feature=...} gauges (bounds the
        # metric cardinality on wide models)
        "obs_drift_topk": ("int", 10),
        # minimum joined (prediction, outcome) pairs before online
        # AUC/logloss emit as `online_quality` events
        # (ServingPredictor.record_outcome delayed-label channel)
        "obs_drift_min_labels": ("int", 100),
        # incident engine (obs/incident.py): debounce + group every
        # detector channel's anomaly signals (health, SLO burn,
        # straggler skew, watchdog near-expiry, recompiles, drift,
        # shed storms, operator POSTs) into schema-15 incident events,
        # capturing a host-side evidence bundle at open
        "obs_incident": ("bool", False),
        # quiet seconds after the last grouped signal before the open
        # incident closes; co-occurring signals inside the window join
        # the SAME incident instead of opening new ones
        "obs_incident_window_s": ("float", 5.0),
        # evidence-bundle directory; "" anchors next to the timeline as
        # <obs_events_path>.incidents (no bundles without an events
        # path — incident events still land in the timeline)
        "obs_incident_dir": ("str", ""),
        # arm a one-iteration jax.profiler trace window when an
        # incident opens mid-training (PR-1 trace plumbing; never armed
        # on the serve hot path, which has no iteration to scope to)
        "obs_incident_trace": ("bool", False),
        # continuous host sampling profiler (obs/prof.py): samples per
        # second for the daemon-thread sys._current_frames walker that
        # folds stacks into schema-16 `prof_profile` windows.  0 = off.
        # Runs only when the observer is otherwise enabled — the default
        # does NOT by itself turn the observer on.  29 is deliberately
        # prime-ish so the jittered clock cannot alias with 10/50/100 Hz
        # periodic work.
        "obs_prof_hz": ("int", 29),
        # window length: samples aggregate into one `prof_profile` event
        # per window (top-K folded stacks + per-role/stage/phase totals)
        "obs_prof_window_s": ("float", 5.0),
        # folded stacks kept per window; the dropped tail is counted in
        # the event's `truncated` field, never silently lost
        "obs_prof_topk": ("int", 20),
        # serving tier (lightgbm_tpu/serve/, docs/Serving.md) — the
        # Booster.serve() microbatcher over AOT-compiled predict
        # executables.  Largest coalesced microbatch (and the largest
        # compiled batch bucket); bigger requests run in max_batch
        # chunks through the same executables.
        "serve_max_batch": ("int", 8192),
        # coalescing deadline: a microbatch flushes when it reaches
        # serve_max_batch rows OR the oldest queued request has waited
        # this many milliseconds — the knob trading p99 latency for
        # bucket fill / throughput
        "serve_max_delay_ms": ("float", 2.0),
        # smallest batch bucket: request rows round UP to the nearest
        # power of two between serve_bucket_min and serve_max_batch, so
        # the executable cache holds at most
        # log2(max_batch / bucket_min) + 1 programs per route
        "serve_bucket_min": ("int", 64),
        # donate the encoded input buffers to the predict executable
        # ('auto' | 'true' | 'false'); auto donates on accelerator
        # backends and keeps CPU un-donated (the CPU runtime lacks
        # donation and would warn per call)
        "serve_donate": ("str", "auto"),
        # emit a `serve_batch` timeline event every Nth microbatch when
        # an observer is attached (0 = off; metrics always record)
        "serve_batch_event_every": ("int", 0),
        # overload protection (serve/scheduler.py): bound the microbatch
        # queue at this many requests; arrivals beyond it are shed at
        # admission with ServeOverloadError (0 = unbounded).  Shedding
        # is never silent: lgbm_serve_shed_total counts by route+reason
        "serve_queue_limit": ("int", 0),
        # default per-request latency budget: a request whose projected
        # queue wait (coalescing delay + backlog batches x EWMA execute
        # time) already exceeds it is shed at admission instead of
        # queueing doomed work (0 = no deadline; per-request override
        # via submit(deadline_ms=...)).  Distinct from serve_deadline_ms,
        # which is the historical alias of the serve_max_delay_ms
        # coalescing deadline
        "serve_request_deadline_ms": ("float", 0.0),
        # emit a `serve_request` trace event for every Nth completed
        # request when an observer is attached: the request's latency
        # decomposed into queue / encode / pad / execute / respond
        # spans, with its batch id and bucket (0 = off)
        "serve_request_event_every": ("int", 0),
        # rolling-SLO targets (obs/serve.py SloEngine): p99 latency
        # target in ms and sustained-QPS floor; 0 disables the target.
        # Breaching the p99 budget (1% of requests may exceed the
        # target) faster than 2x on BOTH burn windows fires a
        # `slo_burn_rate` health event through the obs_health channel
        "serve_slo_p99_ms": ("float", 0.0),
        "serve_slo_qps": ("float", 0.0),
        # long rolling window for SLO aggregation (the short burn
        # window is window/6, SRE multi-window convention)
        "serve_slo_window_s": ("float", 60.0),
        # emit a `serve_slo` snapshot event every this many seconds
        # when an observer is attached (0 = off; alert evaluation
        # keeps its own cadence)
        "serve_slo_every_s": ("float", 10.0),
    }

    # keys accepted for config-file compatibility whose behavior differs
    # from the reference in this framework (VERDICT r1 weak #7)
    _BEHAVIOR_DIFFERS = {
        "sparse_threshold": ("bin storage is dense on TPU; sparse inputs "
                             "are binned without densification but stored "
                             "as dense bin columns"),
    }

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 raise_unknown: bool = False):
        params = dict(params or {})
        params = key_alias_transform(params, raise_unknown=raise_unknown)
        self.raw: Dict[str, Any] = params
        for name, (kind, default) in self._FIELDS.items():
            if name in params and params[name] is not None:
                val = params[name]
                if kind == "int":
                    val = _to_int(val)
                elif kind == "float":
                    val = float(val)
                elif kind == "bool":
                    val = _to_bool(val)
                elif kind == "str":
                    val = str(val)
                elif kind == "strvec":
                    if isinstance(val, str):
                        val = [s for s in val.replace(";", ",").split(",") if s]
                    elif not isinstance(val, list):
                        val = list(val)
                    else:
                        val = list(val)
                elif kind == "floatvec":
                    val = _to_double_vec(val)
                elif kind == "intvec":
                    val = _to_int_vec(val)
            else:
                val = default
            setattr(self, name, val)
        # alternate names that land in the same slot
        if "machine_list_filename" in params:
            self.machine_list_file = str(params["machine_list_filename"])
        if "data_filename" in params:
            self.data = str(params["data_filename"])
        if "valid_data_filenames" in params and params["valid_data_filenames"]:
            v = params["valid_data_filenames"]
            self.valid_data = v if isinstance(v, list) else str(v).split(",")
        if "is_provide_training_metric" in params:
            self.is_training_metric = _to_bool(params["is_provide_training_metric"])
        if "subsample_for_bin" in params:
            self.bin_construct_sample_cnt = _to_int(params["subsample_for_bin"])
        if "device" in params:
            self.device_type = str(params["device"])
        if "poission_max_delta_step" in params:  # reference's typo'd key
            self.poisson_max_delta_step = float(params["poission_max_delta_step"])
        # accepted-for-compat keys whose reference behavior differs here:
        # warn so a migrating user is not silently surprised
        for key, why in self._BEHAVIOR_DIFFERS.items():
            if key in params and params[key] not in (None, False, "false", "0"):
                Log.warning("Parameter %s is accepted for compatibility but "
                            "%s", key, why)
        self.check_param_conflict()

    # --- semantics from OverallConfig::CheckParamConflict (src/io/config.cpp)
    def check_param_conflict(self) -> None:
        if self.num_leaves < 2:
            Log.fatal("num_leaves must be >= 2, got %d", self.num_leaves)
        if self.max_bin < 2 or self.max_bin > 65535:
            # bin ids must fit the uint16 stores (io/dataset.py binned
            # matrices and the EFB conflict sample)
            Log.fatal("max_bin must be in [2, 65535], got %d", self.max_bin)
        if self.is_pre_partition and self.num_machines <= 1:
            self.is_pre_partition = False
        if self.max_depth > 0:
            full = 1 << min(self.max_depth, 30)
            if self.num_leaves > full:
                self.num_leaves = full
        obj = self.objective
        if obj in ("multiclass", "multiclassova", "softmax") and self.num_class <= 1:
            Log.fatal("Number of classes should be specified and greater than 1 for multiclass training")
        if obj not in ("multiclass", "multiclassova", "softmax") and self.num_class != 1:
            Log.fatal("Number of classes must be 1 for non-multiclass training")
        Log.reset_level(self.verbose)

    def metrics(self) -> List[str]:
        """Resolve metric list; empty metric falls back to the objective's
        default metric as the reference's GetMetricType does."""
        if self.metric:
            out = []
            for m in self.metric:
                m = m.strip()
                if m and m not in out:
                    out.append(m)
            return [m for m in out if m not in ("None", "na", "null", "custom", "")]
        default_map = {
            "regression": "l2", "regression_l2": "l2", "mean_squared_error": "l2",
            "mse": "l2", "regression_l1": "l1", "mean_absolute_error": "l1",
            "mae": "l1", "huber": "huber", "fair": "fair", "poisson": "poisson",
            "binary": "binary_logloss", "multiclass": "multi_logloss",
            "softmax": "multi_logloss", "multiclassova": "multi_logloss",
            "lambdarank": "ndcg",
        }
        if self.objective in default_map:
            return [default_map[self.objective]]
        return []

    def __repr__(self) -> str:
        return "Config(%s)" % (self.raw,)
