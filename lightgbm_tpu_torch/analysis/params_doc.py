"""The port's copy of the generator of docs/Parameters.md.

``tools/gen_params_doc.py`` renders the document from the JAX package's
registry, which it imports; the port imports nothing of that package, so
the ``params-doc-stale`` rule (config_coherence.py) renders the same
text from the port's registry (``utils/config.py``) with this copy.  A
difference is a departure of the port's registry from the JAX
package's, to be fixed in the port.
"""
from ..utils.config import ALIAS_TABLE, PARAMETER_SET, Config

# short purpose lines for the keys users reach for most; everything else
# still gets its row (type/default/aliases) from the registry
NOTES = {
    "task": "train / predict / convert_model",
    "objective": "regression, regression_l1, huber, fair, poisson, binary,"
                 " multiclass, multiclassova, lambdarank",
    "boosting_type": "gbdt / dart / goss / infinite (InfiniteBoost)",
    "tree_learner": "serial / feature / data / voting — see "
                    "Parallel-Learning-Guide.md",
    "metric": "l1, l2, rmse, huber, fair, poisson, binary_logloss, "
              "binary_error, auc, multi_logloss, multi_error, ndcg, map",
    "num_leaves": "max leaves per tree (leaf-wise growth)",
    "max_bin": "max feature discretization bins; <=15 enables 4-bit packing",
    "learning_rate": "shrinkage rate",
    "num_iterations": "boosting rounds",
    "min_data_in_leaf": "minimal rows per leaf",
    "min_sum_hessian_in_leaf": "minimal hessian mass per leaf",
    "feature_fraction": "per-tree feature subsample",
    "bagging_fraction": "row subsample (with bagging_freq)",
    "bagging_freq": "re-bag every k iterations (0 = off)",
    "lambda_l1": "L1 regularization on leaf outputs",
    "lambda_l2": "L2 regularization on leaf outputs",
    "min_gain_to_split": "minimal gain to accept a split",
    "max_depth": "depth limit (<=0 = unlimited)",
    "early_stopping_round": "stop when no valid-set metric improves for k "
                            "rounds",
    "categorical_column": "categorical feature spec (indices or names)",
    "use_two_round_loading": "streaming two-round text ingest (bounded "
                             "host memory)",
    "is_save_binary_file": "save the binned dataset for fast reload",
    "histogram_pool_size": "MB budget for the per-leaf histogram cache; "
                           "-1 = auto (see docs/TPU-Tuning.md)",
    "top_k": "voting-parallel top-k (PV-Tree)",
    "num_machines": "process count for multi-host training",
    "is_unbalance": "auto-reweight unbalanced binary labels",
    "scale_pos_weight": "manual positive-class weight",
    "sigmoid": "sigmoid scale for binary/lambdarank",
    "label_gain": "lambdarank per-label gains",
    "max_position": "NDCG truncation for lambdarank",
    "ndcg_eval_at": "NDCG/MAP eval positions",
    "drop_rate": "DART tree drop probability",
    "xgboost_dart_mode": "use xgboost's DART normalization",
    "top_rate": "GOSS large-gradient keep fraction",
    "other_rate": "GOSS small-gradient sample fraction",
    "capacity": "InfiniteBoost ensemble capacity",
    "pred_early_stop": "margin-based prediction early stop",
    "use_missing": "enable missing-value handling",
    "tpu_growth": "auto / exact / wave — growth schedule (wave batches the "
                  "top-W splits per sweep on the MXU)",
    "tpu_wave_width": "W in wave growth; -1 = auto by num_leaves; 1 = the "
                      "reference's exact split order",
    "tpu_wave_order": "auto / batched / exact — wave commit order; exact "
                      "reproduces the leaf-wise split sequence bit-for-bit "
                      "at any W (auto: exact for lambdarank/DART/GOSS/"
                      "InfiniteBoost, batched otherwise)",
    "tpu_wave_chunk": "row-chunk of the wave sweep (VMEM vs scan-overhead "
                      "tradeoff; minimum 256, smaller values clamp)",
    "tpu_wave_lookup": "auto / onehot / compact / gather — the partition "
                       "sweep's per-row split-table lookup; compact "
                       "matches rows against only the W wave parents "
                       "(bit-identical trees, ~L/W less lookup traffic). "
                       "auto: compact on TPU, onehot elsewhere",
    "tpu_histogram_mode": "auto / onehot / scatter / pallas / pallas_t / "
                          "pallas_ct histogram kernels; auto on TPU "
                          "under the wave engine (f32, dense, "
                          "serial/data) = pallas_ct for narrow shapes "
                          "(ncols x bin-pad <= 2048), pallas_t for "
                          "wider VMEM-feasible ones, else onehot (TPU) "
                          "/ scatter",
    "tpu_hist_precision": "auto / hilo / bf16 — Pallas wave-kernel MXU "
                          "product precision: hilo = exact bf16 hi+lo "
                          "split (two dots); bf16 = single "
                          "round-to-nearest term, half the MXU work "
                          "(the reference GPU's single-precision "
                          "histogram trade); auto = hilo",
    "tpu_sparse_kernel": "true / false — with tpu_sparse, use the "
                         "entry-chunk MXU sparse store (Pallas kernel, "
                         "wave growth, serial learner) instead of the "
                         "segment_sum coordinate store",
    "tpu_score_update": "auto / gather / pallas — train-side score "
                        "update engine (score += leaf_value[leaf_id]): "
                        "XLA gather, or the bit-equal Pallas "
                        "compare-select kernel; auto = gather",
    "tpu_wave_compact": "true / false — spectator-row compaction for "
                        "the transposed Pallas wave kernels "
                        "(pallas_ct / pallas_t): late waves gather "
                        "only the rows whose leaf is still splitting "
                        "into capacity tiers (split structure "
                        "unchanged; float fields can drift by f32 "
                        "ulps at multi-tile N); opt-in",
    "tpu_bin_pack": "auto / true / false — 4-bit bin packing (at most 16 "
                    "bins/column: max_bin<=15 plus the reserved bin)",
    "tpu_autotune": "off / prior / measure / force — measured on-device "
                    "kernel autotuner for the wave cell (hist kernel, "
                    "wave width, precision, compaction): off = hand-tuned "
                    "heuristics only, prior = heuristics + decision "
                    "telemetry, measure = microbench the viable cells on "
                    "a cache miss, force = always re-measure; see "
                    "Autotuning.md",
    "tpu_autotune_cache": "autotune decision cache path (JSON); empty = "
                          "autotune_cache.json next to the XLA compile "
                          "cache",
    "tpu_autotune_waves": "timed waves per probed cell in measure/force "
                          "mode (plus one untimed warmup wave)",
    "tpu_fused_iter": "auto / on / off — run each boosting iteration as "
                      "ONE fused device program (gradients + tree growth "
                      "+ score update, ops/fused_iter.py) instead of the "
                      "staged entry chain; bit-identical models either "
                      "way.  auto = fuse where the Pallas wave kernels "
                      "are active or the autotuner measured the fused "
                      "cell as the winner; ineligible configs (DART/"
                      "GOSS/multiclass/custom fobj/obs_health) always "
                      "use the staged chain; see FusedIteration.md",
    "tpu_pallas_interpret": "true / false — run the Pallas wave kernels "
                            "in interpret mode (CPU-executable, for "
                            "tests and parity checks; ignored with a "
                            "warning on TPU)",
    "tpu_sparse": "true / false — device-side sparse bin store (exact "
                  "engine, serial + data-parallel; histograms from "
                  "nonzeros only)",
    "tpu_use_dp": "float64 histograms/scores (gpu_use_dp analog)",
    "tpu_predict": "auto / true / false — rank-encoded device bulk "
                   "prediction (f64-exact routing as int compares; auto "
                   "= device for >=100k-row batches on TPU)",
    "tpu_profile_dir": "write a jax.profiler trace per training run",
    "obs_events_path": "run telemetry: write a structured JSONL event "
                       "timeline (run header, per-iteration phase times, "
                       "compile-vs-execute split, memory snapshots) — "
                       "see Observability.md",
    "obs_timing": "auto / phase / iter / off — telemetry fencing policy: "
                  "phase fences every phase boundary (device-accurate, "
                  "breaks pipelining), iter fences once per iteration "
                  "(the bench protocol), off never fences; auto = phase",
    "obs_memory_every": "emit per-device memory_stats() snapshots every "
                        "N iterations (0 = off)",
    "obs_trace_iters": "a:b — open a jax.profiler trace window over "
                       "iterations [a, b) (requires obs_trace_dir)",
    "obs_trace_dir": "destination of the obs_trace_iters profiler window",
    "obs_flush_every": "flush the JSONL event writer every N events",
    "obs_health": "off / warn / fatal — training health monitors "
                  "(non-finite gradients/hessians/leaf values, EMA loss "
                  "divergence, plateau, memory watermark); warn logs + "
                  "emits health events, fatal additionally aborts the run",
    "obs_health_every": "run the health checks every N iterations",
    "obs_health_divergence": "fire loss_divergence when the gradient "
                             "magnitude exceeds this factor x its EMA on "
                             "two consecutive checks (0 = off)",
    "obs_health_plateau": "fire plateau (warn-only) after N consecutive "
                          "checks with relative EMA movement under 1e-4 "
                          "(0 = off)",
    "obs_health_mem_frac": "memory_watermark threshold: per-device "
                           "bytes_in_use / bytes_limit (0 = off; no-op "
                           "on backends without byte counters)",
    "obs_metrics_path": "export the process metrics registry at run end: "
                        ".prom/.txt = Prometheus textfile format, "
                        "otherwise JSON",
    "obs_metrics_every": "embed a metrics snapshot event into the "
                         "timeline every N iterations (0 = final "
                         "snapshot only when obs_metrics_path is set)",
    "obs_compile": "track the XLA compile cache per jitted entry: every "
                   "(re)compile emits a compile_attr event with the arg "
                   "shape/dtype/donation signature, a diff naming the "
                   "changed axis, and cost/memory analysis estimates",
    "obs_straggler_every": "sample per-shard arrival skew of the "
                           "distributed learners every N iterations "
                           "(each sample fences; 0 = off; no-op on a "
                           "single device)",
    "obs_straggler_warn_skew": "warn through the obs_health channel "
                               "when a straggler sample's skew — "
                               "(max-median)/total per-shard wait — "
                               "exceeds this fraction",
    "obs_watchdog_secs": "hang watchdog: dump a flight record after N "
                         "seconds without training progress (0 = off)",
    "obs_fsync": "os.fsync the timeline shard on run_end",
    "obs_flight_events": "event ring-buffer capacity snapshotted into "
                         "flight records",
    "obs_split_audit": "record every realized split per tree as "
                       "split_audit events: feature, bin/threshold, "
                       "gain, child counts, and the runner-up "
                       "feature + gain margin",
    "obs_importance_every": "emit top-k sparse split/gain importance "
                            "events every N iterations (0 = off) — the "
                            "trajectory behind Booster."
                            "importance_history()",
    "obs_importance_topk": "features kept per importance event "
                           "(<=0 = all used features)",
    "serve_max_batch": "serving tier: max rows per coalesced microbatch "
                       "(and the top executable bucket)",
    "serve_max_delay_ms": "max coalescing wait for the oldest queued "
                          "request before the batch flushes",
    "serve_bucket_min": "smallest AOT executable bucket (power-of-two "
                        "ladder up to serve_max_batch)",
    "serve_donate": "auto / true / false — donate input buffers to the "
                    "serve executables (auto = non-CPU backends)",
    "serve_batch_event_every": "emit every Nth microbatch as a "
                               "serve_batch timeline event (0 = off)",
    "serve_queue_limit": "overload protection: max queued requests "
                         "before admission sheds with "
                         "ServeOverloadError (0 = unbounded)",
    "serve_request_deadline_ms": "default per-request latency budget: "
                                 "admission sheds when the projected "
                                 "wait already exceeds it (0 = off)",
    "serve_request_event_every": "emit every Nth completed request as a "
                                 "serve_request trace event with its "
                                 "span breakdown (0 = off)",
    "serve_slo_p99_ms": "p99 latency target for the rolling SLO engine "
                        "+ burn-rate alerts (0 = no target)",
    "serve_slo_qps": "minimum-QPS target for the SLO verdicts "
                     "(0 = no target)",
    "serve_slo_window_s": "long SLO aggregation window; the burn "
                          "alert's short window is 1/6th of it",
    "serve_slo_every_s": "serve_slo snapshot cadence in seconds "
                         "(0 = snapshots off)",
    "obs_data_profile": "profile the binning sample at Dataset "
                        "construction (missing rates, bin-occupancy "
                        "entropy, constant/near-constant/ID-like "
                        "flags, label balance) into a data_profile "
                        "event; findings route through obs_health",
    "obs_ledger_dir": "cross-run performance ledger: ingest the "
                      "finished run's metrics into this directory on "
                      "clean close (empty = off); `obs trend --check` "
                      "and bench_compare --baseline rolling gate "
                      "against the accumulated history",
    "obs_ledger_suite": "ledger suite label — the coarse comparability "
                        "key rolling baselines group runs by (empty = "
                        "the run context's tool name)",
    "obs_ledger_window": "rolling-baseline window: median/MAD "
                         "statistics cover the last N comparable clean "
                         "runs of the same (suite, shape, device) cell",
    "obs_utilization_every": "roofline attribution: emit a utilization "
                             "rollup event every N iterations — "
                             "achieved-vs-peak FLOP/s and HBM bandwidth "
                             "plus a bound classification per jitted "
                             "entry (implies obs_compile; 0 = off) — "
                             "read back with `obs roofline`",
    "obs_roofline_peaks": "JSON file overriding the device-peak "
                          "registry (per device_kind: peak_flops_f32/"
                          "bf16, peak_hbm_bytes, peak_ici_bytes, "
                          "vmem_bytes); empty = built-in table with "
                          "CPU fallback",
    "obs_http_port": "live telemetry plane: serve /metrics, /healthz, "
                     "/statusz and /events?after=N over HTTP from a "
                     "daemon thread for the life of the run (-1 = off, "
                     "0 = ephemeral port — the bound port is logged and "
                     "stamped into the flight record); turns the "
                     "observer on by itself; zero hot-path syncs — "
                     "follow live with `obs watch <url>`",
    "obs_http_addr": "bind address for the live telemetry server; the "
                     "127.0.0.1 default keeps the plane loopback-only — "
                     "exposing it beyond the host (0.0.0.0) is a "
                     "deliberate act, the endpoints carry params and "
                     "provenance",
    "obs_drift_every": "serving-side drift monitoring: evaluate "
                       "PSI/KS divergence of the submitted traffic vs "
                       "the training-time fingerprint every N rows "
                       "(0 = off); verdicts land as schema-14 `drift` "
                       "events, `lgbm_drift_psi` gauges and the "
                       "obs_health warn channel — read back with "
                       "`obs drift`",
    "obs_drift_window": "rolling drift window in rows; counts reset "
                        "once the window fills so stale traffic "
                        "cannot mask fresh drift",
    "obs_drift_psi": "PSI alert threshold (0.2 is the classic "
                     "'significant shift' line); alerts clear with "
                     "hysteresis at half the threshold",
    "obs_drift_fingerprint": "capture the per-feature binned-histogram "
                             "+ score-distribution fingerprint at "
                             "training time and persist it in the "
                             "model text / binned dataset dir (the "
                             "serving reference; ~free, reuses the "
                             "BinMapper sample)",
    "obs_drift_topk": "features kept per drift event / "
                      "`lgbm_drift_psi` gauge series, ranked by "
                      "divergence",
    "obs_drift_min_labels": "joined (prediction, outcome) pairs "
                            "required before an `online_quality` "
                            "event (rolling online AUC/logloss vs the "
                            "training-time eval reference) is emitted",
    "obs_incident": "arm the incident engine (obs/incident.py): "
                    "detector signals — health warnings, SLO burn, "
                    "drift alerts, shed storms, watchdog near-expiry, "
                    "steady-state recompiles — are debounced and "
                    "grouped into `incident_open`/`incident_close` "
                    "events with an evidence bundle captured at open",
    "obs_incident_window_s": "debounce window: signals arriving within "
                             "this many seconds of the incident's last "
                             "signal join the same incident; a quiet "
                             "window closes it",
    "obs_incident_dir": "directory for evidence bundles (one "
                        "subdirectory per incident: ring slice, "
                        "metrics snapshot, statusz snapshot, flight "
                        "context, thread stacks); empty = alongside "
                        "`obs_events_path` + `.incidents`",
    "obs_incident_trace": "arm a one-iteration `jax.profiler` trace "
                          "window when an incident opens mid-training "
                          "(never on the serve hot path); the trace "
                          "lands in the evidence bundle",
    "obs_prof_hz": "continuous host sampling profiler (obs/prof.py): "
                   "samples per second for the daemon thread that "
                   "folds every thread's stack into schema-16 "
                   "`prof_profile` windows (0 = off; ~29 default, "
                   "prime-ish to avoid aliasing).  Piggybacks on an "
                   "otherwise-enabled observer — never turns the "
                   "observer on by itself; self-measured overhead "
                   "gated <1% by `obs prof --check`",
    "obs_prof_window_s": "profiler window length: samples aggregate "
                         "into one `prof_profile` event per window",
    "obs_prof_topk": "folded stacks kept per window; the dropped tail "
                     "is counted in the event's `truncated` field",
    "ooc_chunk_rows": "out-of-core streaming ingest: rows per chunk "
                      "(the host-memory budget unit; text chunks size "
                      "to it via a bytes-per-row estimate) — see "
                      "OutOfCore.md",
    "ooc_workers": "parallel two-pass binning worker processes "
                   "(0 = all cores; 1 or no fork support = serial)",
    "ooc_binned_dir": "stream the training file into this pre-binned "
                      "mmap-able dataset directory during "
                      "construction; later runs can train straight "
                      "from the directory with zero re-binning",
    "dist_coordinator": "multi-host pod bootstrap: coordinator "
                        "host:port for jax.distributed.initialize "
                        "(empty = JAX_COORDINATOR_ADDRESS env or "
                        "single-process) — see Distributed.md",
    "dist_num_processes": "world size of the pod (0 = "
                          "JAX_NUM_PROCESSES env or single-process)",
    "dist_process_id": "this process's rank in the pod (-1 = "
                       "JAX_PROCESS_ID env)",
    "checkpoint_every": "save a compact booster checkpoint (trees + "
                        "iteration + RNG seeds + config fingerprint) "
                        "every k rounds (0 = off); rank 0 writes "
                        "atomically into checkpoint_dir",
    "checkpoint_dir": "checkpoint directory; a resumable checkpoint "
                      "found here at train() start resumes the run "
                      "(elastic shrink-and-resume after a lost rank "
                      "re-opens re-balanced shards and continues) — "
                      "see Distributed.md",
}

GROUPS = [
    ("Core", ["task", "objective", "boosting_type", "tree_learner",
              "metric", "num_iterations", "learning_rate", "num_leaves",
              "max_depth", "num_class", "seed"]),
    ("Learning control", [
        "min_data_in_leaf", "min_sum_hessian_in_leaf", "feature_fraction",
        "feature_fraction_seed", "bagging_fraction", "bagging_freq",
        "bagging_seed", "lambda_l1", "lambda_l2", "min_gain_to_split",
        "early_stopping_round", "drop_rate", "skip_drop", "max_drop",
        "uniform_drop", "xgboost_dart_mode", "drop_seed", "top_rate",
        "other_rate", "capacity", "is_unbalance", "scale_pos_weight",
        "sigmoid", "boost_from_average", "huber_delta", "fair_c",
        "poisson_max_delta_step", "gaussian_eta", "label_gain",
        "max_position", "ndcg_eval_at"]),
    ("IO / dataset", [
        "data", "valid_data", "max_bin", "min_data_in_bin",
        "bin_construct_sample_cnt", "data_random_seed", "has_header",
        "label_column", "weight_column", "group_column", "ignore_column",
        "categorical_column", "use_two_round_loading",
        "is_save_binary_file",
        "enable_load_from_binary_file", "is_pre_partition",
        "is_enable_sparse", "sparse_threshold", "use_missing",
        "enable_bundle", "max_conflict_rate", "input_model",
        "output_model", "output_result", "snapshot_freq", "verbose",
        "metric_freq", "is_training_metric", "ooc_chunk_rows",
        "ooc_workers", "ooc_binned_dir"]),
    ("Prediction", [
        "num_iteration_predict", "is_predict_raw_score",
        "is_predict_leaf_index", "pred_early_stop", "pred_early_stop_freq",
        "pred_early_stop_margin", "convert_model",
        "convert_model_language"]),
    ("Distributed", [
        "num_machines", "top_k", "local_listen_port", "time_out",
        "machine_list_file", "histogram_pool_size",
        "dist_coordinator", "dist_num_processes", "dist_process_id",
        "checkpoint_every", "checkpoint_dir"]),
    ("TPU-native", [
        "tpu_growth", "tpu_wave_width", "tpu_wave_order", "tpu_wave_chunk",
        "tpu_wave_lookup", "tpu_wave_compact", "tpu_histogram_mode",
        "tpu_hist_precision", "tpu_score_update", "tpu_bin_pack",
        "tpu_sparse", "tpu_sparse_kernel", "tpu_use_dp", "tpu_predict",
        "tpu_fused_iter", "tpu_pallas_interpret", "tpu_profile_dir"]),
    ("Autotune", [
        "tpu_autotune", "tpu_autotune_cache", "tpu_autotune_waves"]),
    ("Observability", [
        "obs_events_path", "obs_timing", "obs_memory_every",
        "obs_trace_iters", "obs_trace_dir", "obs_flush_every",
        "obs_health", "obs_health_every", "obs_health_divergence",
        "obs_health_plateau", "obs_health_mem_frac", "obs_metrics_path",
        "obs_metrics_every", "obs_compile", "obs_straggler_every",
        "obs_straggler_warn_skew", "obs_watchdog_secs", "obs_fsync",
        "obs_flight_events", "obs_split_audit", "obs_importance_every",
        "obs_importance_topk", "obs_data_profile", "obs_ledger_dir",
        "obs_ledger_suite", "obs_ledger_window", "obs_utilization_every",
        "obs_roofline_peaks", "obs_http_port", "obs_http_addr",
        "obs_drift_every", "obs_drift_window", "obs_drift_psi",
        "obs_drift_fingerprint", "obs_drift_topk",
        "obs_drift_min_labels", "obs_incident",
        "obs_incident_window_s", "obs_incident_dir",
        "obs_incident_trace", "obs_prof_hz", "obs_prof_window_s",
        "obs_prof_topk"]),
    ("Serving", [
        "serve_max_batch", "serve_max_delay_ms", "serve_bucket_min",
        "serve_donate", "serve_batch_event_every", "serve_queue_limit",
        "serve_request_deadline_ms", "serve_request_event_every",
        "serve_slo_p99_ms", "serve_slo_qps", "serve_slo_window_s",
        "serve_slo_every_s"]),
]


def aliases_of(key):
    return sorted(a for a, c in ALIAS_TABLE.items() if c == key)


def fmt_default(typ, val):
    if val is None:
        return "(unset)"
    if typ == "bool":
        return "true" if val else "false"
    return str(val)


def render():
    """The full Parameters.md text from the live registry.

    The doc-freshness rule (``params-doc-stale``, config_coherence.py)
    compares it with docs/Parameters.md."""
    fields = dict(Config._FIELDS)
    # parameters accepted via PARAMETER_SET but handled outside the typed
    # field table (config-file plumbing, column-role strings, ...)
    for k in sorted(PARAMETER_SET):
        fields.setdefault(k, ("str", None))
    out = []
    out.append("# Parameters\n")
    out.append(
        "All parameter names, aliases, and defaults match the reference "
        "(include/LightGBM/config.h:87-489); `tpu_*` keys are this "
        "framework's additions.  GENERATED from the live registry by "
        "`tools/gen_params_doc.py` — edit that script, not this file.\n")
    covered = set()
    for title, keys in GROUPS:
        out.append("\n## %s\n" % title)
        out.append("| parameter | type | default | aliases | note |")
        out.append("|---|---|---|---|---|")
        for k in keys:
            if k not in fields:
                raise SystemExit("GROUPS key %r is not a known parameter"
                                 % k)
            covered.add(k)
            typ, dv = fields[k]
            al = ", ".join(aliases_of(k)) or ""
            note = NOTES.get(k, "")
            out.append("| %s | %s | %s | %s | %s |"
                       % (k, typ, fmt_default(typ, dv), al, note))
    rest = sorted(set(fields) - covered)
    if rest:
        out.append("\n## Other accepted keys\n")
        out.append("| parameter | type | default | aliases |")
        out.append("|---|---|---|---|")
        for k in rest:
            typ, dv = fields[k]
            out.append("| %s | %s | %s | %s |"
                       % (k, typ, fmt_default(typ, dv),
                          ", ".join(aliases_of(k))))
    return "\n".join(out) + "\n"
