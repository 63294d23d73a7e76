#!/usr/bin/env python3
"""Chip smoke test of lightgbm_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--rows 2000000] [--sparse-rows 500000] [--profile]
                          [--sweep] [--seed 0]

It builds the port's CUDA kernels from lightgbm_tpu_torch/csrc, holds each
against its plain torch version at the main paths' shapes, times it,
trains the flagship binary recipe (under wave growth, under wave growth
through the plain partition and B3, under exact growth and under wave
growth on the row-major bins; with DART, GOSS and InfiniteBoost),
softmax over 7 classes on the flagship features, early stopping, and
the Bosch-shaped sparse recipe through ``lightgbm_tpu_torch.train``,
then predicts in bulk and serves requests through ``Booster.serve``,
then drives the file path (``python -m lightgbm_tpu_torch`` on TSV
files, the host library), the Python API (the python-guide examples,
lambdarank at MSLR-WEB10K's shape, custom objectives, pickling, cv and
the scikit-learn estimators), out-of-core ingest (two-round streaming, a
pre-binned directory paged to the card), the LGBM_* C ABI and distributed
training (two rank processes on the card over gloo), and checks what
comes out, then the elastic drill, the coordinate store over two ranks,
sharded prediction and serving and the static analyzer (phase 16).
Any failed check ends the run with a non-zero exit code and no result
line.  Without a CUDA device it exits non-zero at once.

Phases, in order:
 1. The card's name and power limit (nvidia-smi); the kernels' build.
 2. Kernel against plain at N rows, F = 28, B = 63, K = W = 32, on the
    flagship data's own bins: B1 (fused wave step; its routing pass must
    list every row in a child slot once, and 32 warps a SM must stay
    resident), B3 (histogram only, K = 32 on B1's routed ids and the
    root's K = 1; its select pass must list the rows as plain does), B4
    (histogram only on the row-major bins, K = 32 and K = 1), B5 (leaf
    histogram as the exact grower calls it: one leaf of a 64-leaf state
    with row multipliers, and leaf 0 holding every row; each also at one
    copy of its block histogram) and B2 (score update in place, clip
    folded in, plain from a copy taken before).
    Leaf ids and the score update must be exactly equal; two launches of
    a histogram kernel must be bit-identical; with B1's fixed-point
    exponents B3 on B1's routed ids must give B1's histogram to the bit,
    B4 B3's in both forms, and B5 B4's at K = 1 in both forms.
    Histograms are held against the plain version computed in float64:
    an f32 sum over many rows errs in proportion to the sum of its terms'
    magnitudes, so a cell may differ by at most 1e-5 x (sum of |w| over
    the cell) + 1e-5 x max|w|.
 3. Timing: each kernel's time a launch, the median of 5 runs of 20
    back-to-back launches (3 runs of 3 for calls above 5 ms: the plain
    versions and the library calls), each run between one
    pair of CUDA events, beside the plain version, one PyTorch library
    call for the same function and the bound (bytes over 3.35 TB/s, f32
    adds over 67 TFLOP/s, whichever is larger: the published H100 SXM row
    of lightgbm_tpu_torch/obs/roofline.py, which the autotuner's probe
    stamps divide by too).  --sweep also times B5 on B4's chain and B6
    at 256, 512 and 1024 threads.
 4. Training: bench.py's flagship recipe and data, every launch counter
    set to 0 just before and read just after, on the fused iteration
    (tpu_fused_iter=auto on the card: a tree graph of the gradients, the
    root and M masked waves, one host read, tail-wave graphs only if the
    tree is not done, a B2 graph) and then staged (tpu_fused_iter=off) in
    the same call, whose model text must equal the fused run's to the
    byte; each run prints its chain, its graph capture seconds (set-up),
    replays, host reads and the trees that needed tail waves.  Launches:
    B1 once a wave pass (fused: M + tail waves a tree; staged: the waves
    that split), B3 once a tree, B2 once an iteration.  The valid AUC
    must exceed 0.8, the device-side scores must agree with the host-side
    trees, and a small run on the card must grow the trees the CPU grows.
    Then the same pair with tpu_histogram_mode=pallas_t (B3 once a wave
    pass and once a tree, no other histogram kernel, and the main path's
    model text to the byte), with tpu_growth=exact,
    tpu_histogram_mode=pallas (staged; B5 once for the root and once a
    split, no other histogram kernel) and the pair with tpu_growth=wave,
    tpu_histogram_mode=pallas (B4 once a wave pass and once a tree, and
    the main path's model text to the byte); each run prints its steady
    rate, its waves or splits a tree and its host reads a tree.
 4e. Boosting modes and multiclass, staged (the JAX package's fused
    iteration takes neither), each with its launches a tree checked as
    in phase 4 (B2 once a tree), its valid metric at each iteration,
    steady and whole-call rate, trees/s, waves and host reads a tree:
    DART (10 iterations, drop_rate 0.1, drop_seed 4; its drops printed),
    GOSS (15 iterations, top_rate 0.2, other_rate 0.1, no sampling in
    the first 10; its kept rows printed) and InfiniteBoost (5
    iterations, capacity 50) on the flagship data with exact-order
    waves, valid AUC above 0.8, DART's and GOSS's device scores equal to
    their host trees; softmax over 7 classes (Covertype's count) on the
    flagship features, labels the argmax of a noisy linear score,
    binned with the flagship's mappers, 5 iterations = 35 trees (35 B2
    launches), multi_logloss falling every iteration, device scores
    equal to the host trees and the model text reloading to the same
    (N, 7) probabilities to 1e-6.  Then early stopping on 20,000 rows
    (stops before 200 rounds; predict at best_iteration equals a fresh
    run of that many rounds), small card-against-CPU runs of softmax,
    OVA, L1, Huber, Fair, Poisson, DART and InfiniteBoost, and GOSS
    through its first sample (goss_matches_cpu says why no further).
    Early stopping is held on the valid binary_logloss; where it stops
    on the flagship's AUC is printed.
 5. Sparse: tools/tpu_ab2.py's Bosch-shaped data (968 columns, 1% dense,
    built directly as CSR; --sparse-rows rows, 500,000 by default, half
    of Bosch's), binned sparsely, in the entry-chunk store.
    Kernel B6 against its plain version in float64 at K = 32 on a
    grower-like leaf state and at the root's one slot (phase 2's
    tolerance, fill and inactive slots exactly 0, repeats and another
    thread count bit-identical, every non-fill cell bit-equal to B3's on
    the dense bins rebuilt from the store on the card, the one-slot root
    bit-equal to the 32-slot call with slot 0 active) and its timing as
    in phase 3; then
    training with tpu_sparse and tpu_sparse_kernel, fused and then
    staged, every counter set to 0 just before each and read just after:
    B6 once a wave pass and once a tree (the root), B1 and B3 never, B2
    once an iteration, valid AUC above 0.8, the two model texts equal to
    the byte, device valid scores equal to the host trees, a model text
    round trip, and a small sparse run on the card that grows the CPU's
    trees and the dense path's trees.
 7. Prediction and serving at bench_serve.py's full shape (200,000 rows
    x 28 features, binary, 255 leaves, max_bin 63, 100 rounds, trained
    fused): bulk prediction of 2,000,000 fresh rows under
    tpu_predict=auto through the ranked traversal on the card, a
    200,000-row slice held against the host trees (raw within rtol and
    atol 2e-6, leaf indices equal); the model text loaded with
    device="cuda" giving the same raw scores to the bit; then
    booster.serve(max_batch=4096, max_delay_ms=2.0) with the bucket
    ladder 64..4096 captured as CUDA graphs (raw and converted) and
    bench_serve.py's closed loop (8 threads, 5,000 requests): no capture
    after warm-up, no shed, every request on the device route, every
    response equal to its rows served alone and within 2e-6 of the host
    trees, and the es and contrib routes equal to Booster.predict.  It
    prints rows a second of both bulk paths with the encode and device
    split, p50/p99 latency, requests and rows a second, batches, pad
    rows and the graphs' memory.
 8. The file path on phase 7's data (its first FILE_ROWS = 100,000 x 28
    training rows and 100,000 fresh rows with their labels) at the
    flagship's params: both written
    as TSV (%.17g), ``python -m lightgbm_tpu_torch task=train`` in a
    subprocess on the card (5 iterations, model text equal to an
    in-process ``train`` on the same arrays, to the byte),
    ``Dataset.construct()`` through the host library and its Python
    fallback on the first 20,000 rows (equal bins and bounds, both
    timed), ``task=predict`` on the
    fresh rows through the device path (the file equal to
    ``Booster.predict`` printed with %.9g), ``input_model=`` plus 5
    rounds (10 trees, scores from the base model's f64 host trees, valid
    AUC no lower than the base's less 1e-3), checkpoint resume (3 rounds,
    then 5: 2 more trained, the first 3 trees kept), and the host trees
    of phase 7's model in rows a second, native against Python.
 9. The Python API on the card.  9a: examples/python-guide's four
    examples, each with its one line ``import lightgbm_tpu as lgb``
    replaced by ``import lightgbm_tpu_torch as lgb`` (the line must be
    there once; examples/ is not edited), run at once in four processes
    on the default device: each must exit 0 with output; their seconds.
    9b: lambdarank at MSLR-WEB10K's published shape, synthetic from
    --seed: 5,000 queries (half of MSLR's 10,000, a cut in rows that
    keeps the script in its time) of lognormal length (mean 120, clipped to
    1-1,000), 136 features, labels 0-4 at about MSLR's skew cut from a
    hidden linear score plus noise (shares printed), 2,000 more queries
    as the valid set; examples/lambdarank/train.conf's params (31 leaves,
    learning rate 0.1, NDCG at 1, 3, 5, max_bin 255); 5 iterations fused
    then staged, equal model text, B3 on every wave (136 x 256 bins are
    past the ct bound), NDCG@5 rising; one get_gradients call timed on
    the card against get_gradients_host on the host, their largest gap
    within rtol 2e-4 / atol 2e-5; binning seconds, the graphs' pools.
    9c (run after phase 4, on its rows): a fobj returning the port's
    BinaryLogloss gradients (boost_from_average=false) trains phase 4's
    trees, every Tree= section to the byte, on the staged chain; a numpy
    logistic fobj with a feval for 5 rounds, valid AUC above 0.8, its
    it/s.  9d: pickle and deepcopy of phase 7's model predict the same
    bits; cv(nfold=5, stratified=True) on 100,000 rows of phase 7's data
    (auc-mean); LGBMClassifier at the flagship's params and LGBMRanker on
    9b's data train train's model text.  Every in-process run is counted
    into the kernel line.
10. (run after phase 4d) The kernels' packed and bf16 forms
    (forms_phase): their checks and times (packed B1, B3, B4 at F = 28,
    B = 16 on the flagship rows binned at max_bin 15, each bit-equal to
    the byte bins' kernel; bf16 B1, B3, B4 at B = 63 with tie weights,
    each the unrounded form on the rounded weights to the bit);
    the max_bin 15 flagship on byte bins, then packed on pallas_ct,
    pallas_t and pallas, fused and staged, each text the byte bins' to
    the byte with X at half the bytes; bf16 on the main path, fused and
    staged (equal text, valid AUC within 1e-3 of phase 4's), and on
    pallas_t and pallas (pallas_ct's bf16 text); tpu_wave_compact=true
    on pallas_ct (taken; the full pass runs under it: the main path's
    text).  Every launch of a form is counted in the form's own counter.
    Phase 5 adds B6's bf16 form to its checks, a reading of the rebuilt
    fill bins' bf16 offset at the root, and a bf16 booster on its
    Dataset, fused then staged (equal text, every B6 launch bf16; its AUC
    printed beside the unrounded run's; a small bf16 sparse run on the
    card grows the CPU's trees).
11. (run after phase 4d, on its Dataset) The measured autotuner and the
    run observer (autotune_phase): tpu_autotune=measure with a fresh
    cache file and a timeline under obs_timing=iter; every cell that
    ops/autotune.py enumerates for the flagship's bucket probed on the
    card (seconds a probe tree, roofline position, the winner, its
    margin and the probe seconds printed; the probes' launches counted
    apart); the cache holding one entry keyed
    <card kind>|v2|c28_b64_l255_n<row bucket>; a second run under
    tpu_autotune=prior from the cache with no probe event; the measured
    run's text equal to a run with the winner pinned, to the byte; every
    event valid (strict); ``obs explain`` exit 0 naming every probe; the
    fence audit (0 over a NULL-observer run, the probes' runs plus one an
    iteration under iter); an obs_trace_iters=2:3 window whose
    torch.profiler trace names the port's kernels.  In 9b, measure on the
    ranking Dataset (ROADMAP A4.8: B1 a candidate past the ct bound), its
    winner printed.
12. Out-of-core ingest and the C API (phase 12: streamed_phase after
    phase 4d, on its rows; 12b inside phase 8, on its files; abi_phase
    after phase 8, on phase 7's rows).  12a: phase 4's training rows
    saved as a float32 .npy, streamed in two rounds (from_streamed, the
    default workers, forked after the card has trained) to a binned
    directory whose mappers and bins must be phase 4's Dataset's; train
    fused on the directory through the paged upload (its shards, bytes,
    seconds and GB/s printed), whose model text must be phase 4's fused
    text to the byte; in fresh processes, the peak-RSS growth of
    construction and of the paged upload against bounds fixed before
    the first card run (OOC_BUILD_RSS_BOUND; a shard, its staging and
    OOC_UPLOAD_SLACK).  12b: phase 8's TSV through the CLI with
    use_two_round_loading=true: phase 8's model text and predict file.
    12c: phase 7's 200,000 x 28 rows through the port's C ABI library
    (g++, ctypes.CDLL): DatasetCreateFromMat, BoosterCreate, 5 x
    UpdateOneIter, SaveModelToString, PredictForMat, and a dataset of
    DatasetPushRows: train's model text, predictions within 2e-6 of
    Booster.predict.
13. (run after phase 10) Two-byte bins, the f64 form and the XLA
    engines (wide_phase), on the first CUT_ROWS of the flagship rows.
    13a-c: the uint16 forms of B1, B3, B4 and B5 at F = 28, B = 1023,
    K = 32 on those rows binned at max_bin 1023, their byte forms at B =
    255 on the rows binned at max_bin 255, and their f64 forms at B = 63
    with float64 weights, each against its plain version in float64 (the
    f64 forms within 1e-12 x the cell's sum of |w| + 1e-14 x max|w|),
    repeats bit-identical, B3 = B1, B4 = B3 and B5 = B4's slot, and B1
    and B3 (K = 32 and the root) the scatter engine's histogram, to the
    bit with B1's exponents, and timed as in phase 3 (B3 at K = 32 too),
    each with its plan and the reads a listed row costs; the bin tiles: B3
    and B4 on 4 flagship columns binned at max_bin 16383, past one
    shared-memory row.  13d: the
    flagship at max_bin 1023 through auto (pallas_t: B3), pallas_ct
    (B1), pallas (B4) and exact growth (B5), fused then staged with
    equal text, every launch the uint16 form, the wave texts one.  13e:
    tpu_use_dp at max_bin 63 (pallas_ct fused then staged, pallas and
    exact fused): every launch the f64 form, the gather for the scores.
    13f: onehot and scatter under wave (fused and staged) and exact
    growth (fused), no kernel; scatter gives phase 4's and 4b's texts to
    the byte; tpu_score_update=gather gives the main text.  13g: the
    flagship at max_bin 255 (byte bins, the slot-ordered pass) through
    auto (B3) and pallas_ct (B1), fused, one text.
14. The coordinate sparse store and the single-process observers.  14a
    (after phase 5, on its Dataset): tpu_sparse=true without
    tpu_sparse_kernel, wave growth (W = 32) fused, fused again and
    staged, exact growth fused for 3 iterations; the store's sums are
    plain torch (no kernel launches but B2); the wave texts one and phase
    5's entry-chunk text; its device bytes beside the entry-chunk
    store's.  14b: DART (10 iterations, drop_rate 0.1), a rollback and
    continued training from init_model on both sparse stores from the
    raw rows (the Bosch recipe at 5,000 rows, dense), the scores
    following the trees.  14c (after 12a, on phase 4's Dataset): the main
    path fused with obs_compile, obs_utilization_every, the watchdog, the
    default sampling profiler, the incident engine, the live plane
    (obs_http_port=0, scraped from a thread) and the ledger, and without
    any observer: one text, phase 4's; `obs recompiles --check`, `obs
    roofline` and `obs prof --check` pass on the timeline; on 20,000
    rows a stalled callback makes the watchdog write a flight record and
    a fobj with one NaN opens an incident.  14d (inside phase 7): its
    booster serves its fresh rows under bench_serve.py's closed loop (8
    threads, 2,000 requests) without and with a run observer, drift
    monitoring and the live plane: p50 and p99 of each, no capture
    after warm-up, in-distribution traffic raises no drift alert and a
    shifted feature raises one.
15. Distributed training (lightgbm_tpu_torch/parallel).  15a (inside
    phase 2): the deferred-finish forms of B1, B3, B4 and B5 over the two
    halves of the rows (the other half's leaf ids -1), their int64 sums
    added and converted by the finish alone (wave_kernels.finish_hist),
    bit-equal to one launch over the union; each form and the finish
    timed as in phase 3.  15b (after 4d): two rank processes started by
    parallel/launch.py on the one card over gloo, the flagship at full
    width, rank r the r-th contiguous half of phase 4's rows through
    from_matrix(comm=), 5 iterations staged with the valid rows split
    alike: byte-equal texts on the ranks; B1, B3 (their deferred forms),
    the finish and B2 launched on every rank; the AUC of rank 0's model
    on all the valid rows within 2e-4 of a serial run on the same bins
    (rank 0's mappers, saved with its Dataset, binning all the rows:
    the distributed bin finding bins otherwise than phase 4, whose AUC
    gap is printed for both runs); steady it/s a rank, the collectives'
    time a pass and bytes a tree, the trees that split as the serial
    run's.  15c: 200,000 of the rows: feature-parallel (every rank all
    rows) byte-equal to serial exact growth; voting with top_k 28 and
    data-parallel exact growth (B5's deferred form), 2 trees each,
    splitting as serial exact growth, and voting with top_k 5 a 255-leaf
    tree of train AUC > 0.8, on the ranks' halves of a directory saved
    from the serial Dataset (from_binned(comm=)).
16. The rest of distributed and the static analyzer.  16a (after 14a):
    the elastic drill (parallel/elastic.py run_elastic): two rank
    processes over gloo train the flagship recipe at full width (28
    features, 255 leaves, max_bin 63) data-parallel on the first
    ELASTIC_ROWS of the flagship rows, saved as a pre-binned directory,
    5 iterations with checkpoint_every=1; rank 1 dies (os._exit) after
    iteration 2 and the world-1 relaunch resumes from the checkpoint:
    2 attempts, world 1, a flight record naming rank 1, a mesh_shrink
    event; the text's first 2 trees an uninterrupted 2-rank run's to the
    byte, and the whole text a serial init_model continuation's from
    those trees on the same directory.  16b: two ranks train the
    coordinate store (tpu_sparse=true) data-parallel on the first
    DP_SPARSE_ROWS of phase 5's Bosch-shaped Dataset, saved as a
    directory: byte-equal texts on the ranks, the tree structure of a
    serial coordinate-store run on the same directory, B2 the only
    launch; it/s a rank and the all-reduce's ms a pass.  16c (after
    phase 7, on its model and rows): ranked_predict_sharded over
    ["cuda:0", "cuda:0"] on the 200,000 training rows bit-equal to
    ranked_predict, Booster.predict through set_predict_devices too;
    bench_serve.py's closed loop (8 threads, SHARDED_REQUESTS requests,
    raw scores) on a serving predictor over the two entries and on one
    device: responses bit-equal, no capture after warm-up, p50 and p99
    of each.  16d: ``python -m lightgbm_tpu_torch lint --check`` exits 0
    (the analyzer imports no jax).
 With --profile, every training run of phases 4 and 5 and the
 multiclass run profile one more iteration: its wall time, device busy
 share, device operations and graph replays; phase 7 profiles one
 replay of the 4096-row serving graph.
 6. One JSON line of kernels, the card line, and the result line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 20
GROUPS = 5
# calls slower than this (the plain versions, the library yardsticks)
# are timed over SLOW_GROUPS runs of 3 calls, which keeps the script
# within its time
SLOW_MS = 5.0
SLOW_GROUPS = 3
VALID_ROWS = 200_000
# rows of phase 8's checks of the host library against its Python
# fallback (binning, host trees), few enough to keep the script within
# its time
FALLBACK_ROWS = 20_000
# rows of the valid and train sets whose device scores each run holds to
# the host trees
CHECK_ROWS = 100_000
ITERS = 5
CLASSES = 7                   # UCI Covertype's class count
SPARSE_COLS = 968             # Bosch's width (BASELINE.md)
SPARSE_DENSITY = 0.01
# (whole-call, steady) it/s of each dense training run, by its label
RATES = {}
# the last iteration's valid AUC of each dense training run, by its label
AUCS = {}
# phase 12b's and 12c's launches (file_phase and abi_phase), by path
PHASE12 = {}
# phase 7: bench_serve.py's full shape (:41-51, :168-170, :224-228)
SERVE_ROWS = 200_000
SERVE_ROUNDS = 100
SERVE_LEAVES = 255
BULK_ROWS = 2_000_000
SERVE_REQUESTS = 5000
SERVE_THREADS = 8
SERVE_SIZES = (1, 8, 32, 100, 256, 512, 1024)
SERVE_MAX_BATCH = 4096
# phase 9: the python-guide examples, and ranking at MSLR-WEB10K's
# published width (136 features) on 5,000 of its 10,000 queries (cut in
# rows to keep the script in its time) with
# examples/lambdarank/train.conf's params
GUIDE_EXAMPLES = ("simple_example", "advanced_example", "plot_example",
                  "sklearn_example")
GUIDE_IMPORT = "import lightgbm_tpu as lgb"
GUIDE_TMP = "/tmp/"
# the examples that write files under GUIDE_TMP (and read them back)
GUIDE_WRITES_TMP = ("simple_example", "advanced_example", "plot_example")
RANK_QUERIES = 5_000
RANK_VALID_QUERIES = 2_000
RANK_FEATURES = 136
RANK_MEAN_DOCS = 120
RANK_MAX_DOCS = 1000
# label shares 0..4, about MSLR-WEB10K's skew
RANK_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)
CV_ROWS = 100_000
# cuts in rows that keep the script in its time: the flagship rows of the
# max_bin 1023 runs (13d) and of the multiclass run (4e), and the rows of
# phase 7's training and fresh data that phase 8 writes as files
CUT_ROWS = 1_000_000
FILE_ROWS = 100_000


def flagship_params():
    """bench.py's flagship recipe."""
    return {"objective": "binary", "num_leaves": 255, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 1, "verbose": -1,
            "metric": "auc", "tpu_growth": "wave", "tpu_wave_width": 32}


def sparse_params():
    """The flagship recipe on the entry-chunk sparse store."""
    return dict(flagship_params(), tpu_sparse=True, tpu_sparse_kernel=True)


def make_sparse_data(n_rows, seed):
    """tools/tpu_ab2.py's Bosch-shaped recipe as CSR, never dense: nnz
    normal float32 values at uniform (row, column) draws, in the script's
    draw order (its assignment evaluates the values before the indices);
    a coordinate drawn twice keeps its last value, as the script's dense
    assignment does; y = x0 + x1 > 0.02 in float32."""
    import scipy.sparse as sps
    rng = np.random.default_rng(seed)
    nnz = int(n_rows * SPARSE_COLS * SPARSE_DENSITY)
    vals = rng.normal(size=nnz).astype(np.float32)
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, SPARSE_COLS, nnz)
    key = rows * SPARSE_COLS + cols
    uniq, last = np.unique(key[::-1], return_index=True)   # last write wins
    vals = vals[::-1][last]
    r, c = uniq // SPARSE_COLS, uniq % SPARSE_COLS
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n_rows), out=indptr[1:])
    X = sps.csr_matrix((vals.astype(np.float64), c, indptr),
                       shape=(n_rows, SPARSE_COLS))
    x01 = [np.zeros(n_rows, np.float32) for _ in range(2)]
    for j in range(2):
        x01[j][r[c == j]] = vals[c == j]
    return X, (x01[0] + x01[1] > 0.02).astype(np.float64)


def make_data(n_rows, n_features=28):
    """bench.py's data recipe: a noisy linear logit over normal features."""
    rng = np.random.default_rng(42)
    chunks, ys = [], []
    w = None
    for start in range(0, n_rows, 500_000):
        n = min(500_000, n_rows - start)
        X = rng.normal(size=(n, n_features)).astype(np.float32)
        if w is None:
            w = rng.normal(size=n_features) * (rng.random(n_features) > 0.3)
        logit = X @ w * 0.5 + 0.5 * rng.normal(size=n)
        chunks.append(X)
        ys.append((logit > 0).astype(np.float32))
    return np.concatenate(chunks), np.concatenate(ys).astype(np.float64)


def without_fp(text):
    """A model text without its drift_fingerprint= line."""
    return "".join(ln for ln in text.splitlines(keepends=True)
                   if not ln.startswith("drift_fingerprint="))


def need(ok, what):
    if not ok:
        print("chip_smoke: FAILED: %s" % what, file=sys.stderr, flush=True)
        sys.exit(1)


def say(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    need(out.returncode == 0, "nvidia-smi: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=REPS, groups=GROUPS, warmup=3):
    """Milliseconds a call of fn(): the median over `groups` runs of
    `reps` back-to-back calls, each run between one pair of CUDA events
    and divided by its calls, after `warmup` calls.  Where fn()'s host
    work takes longer than its device work, this is the host's rate.  A
    call slower than SLOW_MS is timed over SLOW_GROUPS runs of 3 calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) * 1e3 > SLOW_MS:
        reps, groups = 3, min(groups, SLOW_GROUPS)
    runs = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return float(np.median(runs))


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate, the H100 row of the port's roofline
    registry (obs/roofline.py)."""
    from lightgbm_tpu_torch.obs.roofline import h100_peaks
    hbm_bytes_per_s, f32_flop_per_s = h100_peaks()
    tb, tf = nbytes / hbm_bytes_per_s, flops / f32_flop_per_s
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def hist_err(got, plain, wmax):
    """(max_abs_err, ok) of a kernel histogram against its plain version in
    float64, with the tolerance of phase 2; plain(absolute) computes it
    from the weights, or from their absolute values."""
    want = plain(False)
    diff = (got.double() - want).abs()
    del want
    tol = 1e-5 * plain(True) + 1e-5 * wmax
    return float(diff.max()), bool((diff <= tol).all())


def wave_plain64(fn, X, lid, w3, cid, B):
    """plain(absolute) for a wave histogram kernel's plain version fn."""
    w64 = w3.double()
    return lambda absolute: fn(X, lid, w64.abs() if absolute else w64, cid,
                               B)


def bincount_ms(X_t, slot, w3, B):
    """Time of the library yardstick for a (K, F, B, 3) histogram: one
    torch.bincount a channel over a flattened (slot, feature, bin) index of
    every (row, feature) pair, rows in no slot sent to a spare cell.  The
    index and the per-pair weights are built beforehand and not timed; the
    port never calls this."""
    import torch
    F = X_t.shape[0]
    x = X_t.t().long()                                      # (N, F)
    cell = (slot[:, None] * F
            + torch.arange(F, device=x.device)[None, :]) * B + x
    spare = (int(slot.max()) + 1) * F * B
    cell = torch.where((slot[:, None] >= 0) & (x < B), cell,
                       torch.full_like(cell, spare)).reshape(-1)
    ws = [w3[:, c].repeat_interleave(F).contiguous() for c in range(3)]
    del x
    return time_ms(lambda: [torch.bincount(cell, weights=w,
                                           minlength=spare + 1)
                            for w in ws])


def slots_of(ids, cid):
    """Each row's child slot (-1 for none) and the count of rows in one."""
    import torch
    s = torch.full(ids.shape, -1, dtype=torch.long, device=ids.device)
    for k in range(cid.shape[0]):
        s = torch.where(ids == cid[k], k, s)
    return s, int((s >= 0).sum())


def kernel_phase(X_t, meta_default_bin, wk, lh, tp, clipped_leaf_values,
                 sweep):
    """Phases 2 and 3 on the flagship bins: returns the kernel records."""
    import torch

    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.utils.common import kMaxTreeOutput
    dev = X_t.device
    F, N = X_t.shape
    B, K = 63, 32
    g = torch.Generator(device="cpu").manual_seed(0)
    # a wave state as the grower makes it: 32 leaves, each split once
    lid = torch.randint(0, K, (N,), generator=g, dtype=torch.int32)
    w3 = torch.randn((N, 3), generator=g, dtype=torch.float32)
    f_w = torch.randint(0, F, (K,), generator=g)
    cols = torch.stack([
        torch.ones(K), f_w.float(),
        torch.randint(0, B - 1, (K,), generator=g).float(),
        torch.zeros(K), meta_default_bin.cpu()[f_w].float(),
        torch.randint(0, 2, (K,), generator=g).float(),
        torch.arange(K, 2 * K).float(), torch.zeros(K), torch.zeros(K),
        torch.full((K,), float(B))], dim=-1).contiguous()
    psrc = torch.arange(K, dtype=torch.int32)
    pick_new = torch.randint(0, 2, (K,), generator=g, dtype=torch.int32)
    cid = torch.where(pick_new > 0, psrc + K, psrc)
    lid, w3, cols, psrc, cid = (t.to(dev) for t in (lid, w3, cols, psrc,
                                                    cid))
    root_cid = torch.zeros(1, dtype=torch.int32, device=dev)
    zeros = torch.zeros(N, dtype=torch.int32, device=dev)
    wmax = float(w3.abs().max())
    records = {}

    # ---- B1: fused partition + child histograms; its fixed-point
    # exponents are computed once, as the grower does once a tree
    exps = wk.fixed_point_exponents(w3)
    new_lid, hist = wk.wave_partition_hist(X_t, lid, w3, cid, cols, psrc, B,
                                           exps=exps)
    new_lid2, hist2 = wk.wave_partition_hist(X_t, lid, w3, cid, cols, psrc,
                                             B, exps=exps)
    plain_lid = wk.route_rows_plain(X_t, lid, cols, psrc)
    need(torch.equal(new_lid, plain_lid), "B1 leaf ids differ from plain")
    need(torch.equal(new_lid, new_lid2) and torch.equal(hist, hist2),
         "B1 repeat launch not bit-identical")
    err, ok = hist_err(hist, wave_plain64(wk.wave_histogram_plain, X_t,
                                          plain_lid, w3, cid, B), wmax)
    need(ok, "B1 histogram outside tolerance (max abs err %g)" % err)
    del hist2, new_lid2
    moved = int((new_lid != lid).sum())
    need(moved > 0, "B1 moved no rows")
    # rows are routed once a wave: the routing pass lists every row in a
    # child slot once; and 32 warps stay resident on every SM
    listed = wk.route_list(X_t, lid, cid, cols, psrc)
    need(all(torch.equal(a, b) for a, b in zip(
        listed, wk.route_list_plain(X_t, lid, cid, cols, psrc))),
        "B1 routing list differs from plain")
    plan = wk.hist_plan(F, N, B, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    per_sm = _build.library().lgbt_wave_hist_blocks_per_sm(
        B, plan[3], plan[4], plan[5], 0, 0)
    warps = per_sm * wk._HIST_THREADS // 32
    need(warps >= 32, "B1 keeps %d warps a SM resident" % warps)
    del listed
    slot, n_act = slots_of(plain_lid, cid)
    records["wave_partition_hist"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: wk.wave_partition_hist(X_t, lid, w3, cid, cols,
                                                  psrc, B, exps=exps)),
        plain_ms=time_ms(lambda: wk.wave_partition_hist_plain(
            X_t, lid, w3, cid, cols, psrc, B)),
        library_ms=bincount_ms(X_t, slot, w3, B),
        shape="N=%d F=%d B=%d K=W=%d, %d rows in a child slot, %d moved; "
              "%d feature groups of %d, %d list shares, %d warps a SM"
              % (N, F, B, K, n_act, moved, plan[1], plan[4], plan[2],
                 warps),
        nbytes=(N * (4 + 4 + 1) + n_act * (F + 12) + K * (10 * 4 + 8)
                + K * F * B * 12),
        flops=3 * n_act * F)

    # ---- B3 on X_t and B4 on the row-major X: histogram only, K = 32 on
    # the routed ids, and the root K = 1; all with B1's exponents, so B3
    # on the routed ids must give B1's histogram to the bit, and B4 B3's
    X = X_t.t().contiguous()                                 # (N, F)
    listed = wk.select_list(new_lid, cid)
    need(all(torch.equal(a, b) for a, b in zip(
        listed, wk.select_list_plain(new_lid, cid))),
        "B3/B4 select list differs from plain")
    del listed
    hist_only = (wk.wave_histogram, wk.wave_histogram_plain, X_t)
    rowmajor = (wk.wave_histogram_rowmajor,
                wk.wave_histogram_rowmajor_plain, X)
    same_as = {"wave_histogram_k32": hist}
    for rec_name, (fn, plain, Xk), ids, c, twin in (
            ("wave_histogram_k32", hist_only, new_lid, cid, None),
            ("wave_histogram", hist_only, zeros, root_cid, None),
            ("wave_histogram_rowmajor", rowmajor, new_lid, cid,
             "wave_histogram_k32"),
            ("wave_histogram_rowmajor_root", rowmajor, zeros, root_cid,
             "wave_histogram")):
        h = fn(Xk, ids, w3, c, B, exps=exps)
        h2 = fn(Xk, ids, w3, c, B, exps=exps)
        need(torch.equal(h, h2),
             "%s repeat launch not bit-identical" % rec_name)
        err, ok = hist_err(h, wave_plain64(plain, Xk, ids, w3, c, B),
                           wmax)
        need(ok, "%s histogram outside tolerance (max abs err %g)"
             % (rec_name, err))
        if rec_name in same_as:
            need(torch.equal(h, same_as.pop(rec_name)),
                 "B3 on B1's routed ids is not B1's histogram")
        if twin is not None:
            need(torch.equal(h, same_as.pop(twin)),
                 "%s is not bit-equal to B3 (%s)" % (rec_name, twin))
        else:
            same_as[rec_name] = h
        del h2
        s, n_act = slots_of(ids, c)
        records[rec_name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: fn(Xk, ids, w3, c, B, exps=exps)),
            plain_ms=time_ms(lambda: plain(Xk, ids, w3, c, B)),
            library_ms=bincount_ms(X_t, s, w3, B),
            shape="N=%d F=%d B=%d K=%d%s, %d rows in a child slot; "
                  "plan %s"
                  % (N, F, B, c.shape[0],
                     " row-major" if Xk is X else "", n_act,
                     wk.hist_plan(F, N, B, c.shape[0],
                                  torch.cuda.get_device_properties(
                                      dev).multi_processor_count)[:6]),
            nbytes=(N * 4 + n_act * (F + 12)
                    + c.shape[0] * (4 + F * B * 12)),
            flops=3 * n_act * F)
    need(not same_as, "B3/B4 bit-equality checks left undone")
    del hist
    say("B3 on B1's routed ids equals B1's histogram to the bit; B4 equals "
        "B3 to the bit at K = 32 and at the root; the select list equals "
        "plain")

    # ---- B5: the leaf histogram of exact growth, called as the grower
    # calls it (the tree's weight rows and exponents): one leaf of a
    # 64-leaf state with bagging-like row multipliers, and the root (leaf
    # 0, every row, the grower's all-ones multipliers).  Each must equal
    # B4 at K = 1 on the same ids, w3 and exponents to the bit, and so must
    # B4's chain at K = 1 (the plan B5 keeps past what one block holds),
    # timed with sweep.  Then the leaf sizes of check_b5_sizes.
    from lightgbm_tpu_torch.ops.histogram import weight_rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    L5 = 64
    lid5 = torch.randint(0, L5, (N,), generator=g,
                         dtype=torch.int32).to(dev)
    grad = torch.randn(N, generator=g).to(dev)
    hess = (torch.rand(N, generator=g) + 0.05).to(dev)
    bag = (torch.rand(N, generator=g) > 0.2).float().to(dev)
    ones = torch.ones(N, device=dev)
    plan = wk.hist_plan(F, N, B, 1, sms)[:6]
    lplan = lh.leaf_plan(F, B)
    for name, lids, leaf, rm in (("leaf_histogram", lid5, 5, bag),
                                 ("leaf_histogram_root", zeros, 0, ones)):
        leaf_t = torch.full((1,), leaf, dtype=torch.int32, device=dev)
        w35 = weight_rows(grad, hess, rm)
        e5 = wk.fixed_point_exponents(w35)

        def call():
            return lh.leaf_histogram(X, grad, hess, lids, leaf_t, rm, B,
                                     w3=w35, exps=e5)

        h = call()
        h2 = call()
        need(torch.equal(h, h2), "%s repeat launch not bit-identical" % name)
        need(torch.equal(h, wk.wave_histogram_rowmajor(X, lids, w35, leaf_t,
                                                       B, exps=e5)[0]),
             "%s is not bit-equal to B4 at K = 1" % name)
        g64, h64, rm64 = grad.double(), hess.double(), rm.double()

        def plain64(absolute):
            return lh.leaf_histogram_plain(
                X, g64.abs() if absolute else g64, h64, lids, leaf_t, rm64,
                B)

        err, ok = hist_err(h, plain64, max(float(grad.abs().max()),
                                           float(hess.max()), 1.0))
        need(ok, "%s histogram outside tolerance (max abs err %g)"
             % (name, err))
        need(torch.equal(lh._launch(X, w35, lids, leaf_t, B, e5, plan), h),
             "%s on B4's chain not bit-equal" % name)
        # a gated split that does not commit passes a leaf no row holds
        need(not bool(lh.leaf_histogram(
            X, None, None, lids, torch.full_like(leaf_t, -1), None, B,
            w3=w35, exps=e5).any()), "%s of no row is not zero" % name)
        swept = []
        if sweep:
            swept.append("B4's chain %.4f ms" % time_ms(
                lambda: lh._launch(X, w35, lids, leaf_t, B, e5, plan)))
        del h, h2
        in_leaf = lids == leaf
        n_leaf = int(in_leaf.sum())
        wl = w35 * in_leaf[:, None].float()
        records[name] = dict(
            max_abs_err=err, ms=time_ms(call),
            plain_ms=time_ms(lambda: lh.leaf_histogram_plain(
                X, grad, hess, lids, leaf_t, rm, B)),
            library_ms=bincount_ms(X_t, torch.where(in_leaf, 0, -1), wl, B),
            shape="N=%d F=%d B=%d row-major, leaf %d of %d, %d rows in it; "
                  "one-scan plan %s%s"
                  % (N, F, B, leaf, L5 if leaf else 1, n_leaf, tuple(lplan),
                     "; sweep: " + ", ".join(swept) if swept else ""),
            # leaf ids of every row; the bins, g, h and row multiplier of
            # the leaf's rows only; the (F, B, 3) output
            nbytes=N * 4 + n_leaf * (F + 12) + 4 + F * B * 12,
            flops=3 * n_leaf * F)
        del wl
    say("B5 equals B4 at K = 1 to the bit, on its plan and on B4's chain; "
        "B5 of a leaf no row holds is exactly zero")
    say(check_b5_sizes(lh, wk, X, w35, e5, B, "byte %d bins" % B, g))
    del X

    # ---- B2: score update (255 leaves, ids clamped, values clipped), in
    # place as the training loop runs it; plain from a copy taken before
    L, shrink = 255, 1.7
    score = torch.randn(N, generator=g).to(dev)
    lv = (torch.randn(L, generator=g) * 60).to(dev)
    sid = torch.randint(-1, L + 1, (N,), generator=g,
                        dtype=torch.int32).to(dev)
    vals = clipped_leaf_values(lv, shrink)
    need(bool((vals.abs() == kMaxTreeOutput).any()), "B2 case hits no clip")
    before = score.clone()
    tp.score_update(score, sid, lv, shrink, out=score)
    want = tp.score_update_plain(before, sid, vals)
    need(torch.equal(score, want), "B2 not bit-equal to plain")
    cl = sid.long().clamp(0, L - 1)
    records["score_update"] = dict(
        max_abs_err=float((score - want).abs().max()),
        ms=time_ms(lambda: tp.score_update(score, sid, lv, shrink,
                                           out=score)),
        plain_ms=time_ms(lambda: tp.score_update_plain(score, sid, vals)),
        library_ms=time_ms(lambda: torch.add(score, vals.take(cl))),
        shape="N=%d L=%d" % (N, L), nbytes=N * 12 + L * 4, flops=N)
    for name, r in records.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("flops"))
        say("kernel %-28s %s: %.4f ms, plain %.4f ms, library %.4f ms, "
            "bound %.4f ms (%s), max abs err %.3g"
            % (name, r["shape"], r["ms"], r["plain_ms"], r["library_ms"],
               r["bound_ms"], r["bound_by"], r["max_abs_err"]))
    return records


def sparse_kernel_phase(store, n_rows, num_bins, sm, sweep):
    """Phases 2 and 3 for B6 on the Bosch store, in the two forms the
    grower calls it, with one set of fixed-point exponents as the grower
    makes once a tree: K = 32 child slots on a grower-like leaf state (64
    leaves, each wave's 32 smaller children), and the root call (one
    slot, every row in leaf 0).  Each form is held against the plain
    version in float64, its repeat must be bit-identical, its fill and
    inactive slots exactly 0, and its non-fill cells equal to B3's on the
    dense bins rebuilt from the store on the card (all 968 columns) with
    the same rows and exponents, bit for bit, and so must its launch at
    another count of threads a block; with sweep the threads 256, 512 and
    1024 are timed.  The root's one slot must give the bits of the waves'
    32-slot call shape with only slot 0 active.  Returns the K = 32 form's
    record; the root form's numbers are printed beside it."""
    import torch

    from lightgbm_tpu_torch.ops import wave_kernels as wk
    dev = store.ent_row.device
    F, B, K = store.num_cols, num_bins, 32
    need(B <= 256, "B6 check: %d bins do not fit B3's uint8 bins" % B)
    g = torch.Generator(device="cpu").manual_seed(1)
    lid = torch.randint(0, 2 * K, (n_rows,), generator=g,
                        dtype=torch.int32).to(dev)
    w3 = torch.randn((n_rows, 3), generator=g).to(dev)
    exps = wk.fixed_point_exponents(w3)
    cid = (torch.randperm(2 * K, generator=g)[:K].to(torch.int32)
           .to(dev))
    root_lid = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    root_cid = torch.zeros(1, dtype=torch.int32, device=dev)

    e = store.ent_bin.shape[1]
    rows = store.ent_row.reshape(-1).long()
    bins = store.ent_bin.reshape(-1).long()
    cols = store.chunk_col[:, 0].long().repeat_interleave(e)
    real = rows < n_rows
    rc = rows.clamp(max=n_rows - 1)
    n_ent = int(real.sum())
    present = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    present[rows[real]] = True                  # rows with an entry
    fill = store.fill.long()
    # the dense bins the store was built from: each column's fill bin,
    # then its entries
    t0 = time.perf_counter()
    X_t = store.fill.to(torch.uint8)[:, None].expand(F, n_rows).contiguous()
    X_t[cols[real], rows[real]] = bins[real].to(torch.uint8)
    torch.cuda.synchronize()
    say("B6 check: dense X_t (%d x %d, %.2f GB) rebuilt from the store on "
        "the card in %.2f s" % (F, n_rows, F * n_rows / 1e9,
                               time.perf_counter() - t0))
    fill_cell = torch.zeros((F, B), dtype=torch.bool, device=dev)
    fill_cell[torch.arange(F, device=dev), fill] = True

    def form(name, lid, cid, w3=w3, exps=exps, hilo=True):
        K = cid.shape[0]

        def call():
            return sm.sparse_wave_histogram(store, lid, w3, cid, B, F,
                                            exps=exps, hilo=hilo)

        hist = call()
        again = call()
        need(torch.equal(hist, again),
             "%s repeat launch not bit-identical" % name)
        dense = wk.wave_histogram(X_t, lid, w3, cid, B, exps=exps, hilo=hilo)
        need(torch.equal(hist[:, ~fill_cell], dense[:, ~fill_cell]),
             "%s non-fill cells not bit-equal to B3's" % name)
        del dense, again
        # the weights the sums take: rounded to bf16 in the bf16 form
        wsum = w3 if hilo else wk.round_bf16(w3)
        if not hilo:
            need(torch.equal(hist, sm.sparse_wave_histogram(
                store, lid, wsum, cid, B, F, exps=exps)),
                 "%s is not B6 on the rounded weights" % name)
        want = sm.chunked_child_hists_plain(store, lid, wsum.double(), cid,
                                            B, F)
        scale = sm.chunked_child_hists_plain(store, lid, wsum.double().abs(),
                                             cid, B, F)
        diff = (hist.double() - want).abs()
        tol = 1e-5 * scale + 1e-5 * float(w3.abs().max())
        err = float(diff.max())
        del want, scale
        need(bool((diff <= tol).all()),
             "%s histogram outside tolerance (max abs err %g)" % (name, err))
        need(bool((hist[:, torch.arange(F, device=dev), fill] == 0).all()),
             "%s fill-bin slots not exactly 0" % name)
        need(bool((hist[cid < 0] == 0).all()),
             "%s inactive slots not exactly 0" % name)
        plan = sm.launch_plan(B, K)
        per_sm = min(sm._SMEM_PER_SM // (plan[2] + 1024), 2048 // plan[1])
        blocks = F * -(-K // plan[0])
        other = 256 if plan[1] != 256 else 512
        need(torch.equal(sm._launch(store, lid, w3, cid, B, F, exps,
                                    (plan[0], other, plan[3]), hilo), hist),
             "%s at %d threads not bit-equal" % (name, other))
        swept = []
        for threads in (256, 512, 1024) if sweep else ():
            pc = (plan[0], threads, plan[3])
            swept.append("%d threads %.4f ms" % (threads, time_ms(
                lambda: sm._launch(store, lid, w3, cid, B, F, exps, pc))))
        # the library yardstick: one torch.bincount a channel over a
        # flattened (slot, column, bin) index of the entries, built
        # beforehand; rows in no slot go to a spare cell
        act = cid >= 0
        slot_of_leaf = torch.full((2 * 32,), -1, dtype=torch.long,
                                  device=dev)
        slot_of_leaf[cid.long()[act]] = torch.arange(K, device=dev)[act]
        row_slot = slot_of_leaf[lid.long()]
        slot = row_slot[rc]
        spare = K * F * B
        cell = torch.where(real & (slot >= 0), (slot * F + cols) * B + bins,
                           torch.full_like(rows, spare))
        n_act = int((real & (slot >= 0)).sum())
        ws = [wsum[rc, c].contiguous() for c in range(3)]
        # the bytes the function must move: each entry's row and bin,
        # leaf_id of the rows with an entry, w3 of those rows whose leaf
        # is in an active slot, and the (K, F, B, 3) output
        n_rows_act = int((present & (row_slot >= 0)).sum())
        rec = dict(
            max_abs_err=err, ms=time_ms(call),
            plain_ms=time_ms(lambda: sm.chunked_child_hists_plain(
                store, lid, w3, cid, B, F, hilo)),
            library_ms=time_ms(lambda: [torch.bincount(cell, weights=w,
                                                       minlength=spare + 1)
                                        for w in ws]),
            shape="N=%d F=%d B=%d K=%d (%d active) E=%d, %d entries, %d in "
                  "a child slot, %d rows read w3; plan KS=%d threads=%d "
                  "smem=%d, %d blocks at %d a SM (by shared memory and "
                  "threads): %.2f rounds%s"
                  % (n_rows, F, B, K, int(act.sum()), e, n_ent, n_act,
                     n_rows_act, plan[0], plan[1], plan[2], blocks, per_sm,
                     blocks / (per_sm * torch.cuda.get_device_properties(
                         dev).multi_processor_count),
                     "; sweep: " + ", ".join(swept) if swept else ""))
        rec["bound_ms"], rec["bound_by"] = bound(
            n_ent * 8 + int(present.sum()) * 4 + n_rows_act * 12
            + K * F * B * 12, 3 * n_act)
        say("kernel %-20s %s: %.4f ms, plain %.4f ms, library %.4f ms, "
            "bound %.4f ms (%s), max abs err %.3g"
            % (name, rec["shape"], rec["ms"], rec["plain_ms"],
               rec["library_ms"], rec["bound_ms"], rec["bound_by"],
               rec["max_abs_err"]))
        del ws
        return hist, rec

    hist, rec = form("sparse_wave_histogram", lid, cid)
    # the bf16 form (tpu_hist_precision=bf16) on weights with ties: B6 on
    # the rounded weights to the bit, and B3's bf16 form on the non-fill
    # cells
    w3t = with_ties(w3.cpu(), g).to(dev)
    _, rec_bf16 = form("sparse_wave_histogram_bf16", lid, cid, w3t,
                       wk.fixed_point_exponents(w3t), hilo=False)
    del w3t
    inactive = cid.clone()
    inactive[::2] = -1
    h_in = sm.sparse_wave_histogram(store, lid, w3, inactive, B, F,
                                    exps=exps)
    need(bool((h_in[::2] == 0).all()) and torch.equal(h_in[1::2], hist[1::2]),
         "B6 inactive slots not exactly 0")
    del hist, h_in
    hist, _ = form("sparse_wave_histogram_root", root_lid, root_cid)
    wide = torch.full((K,), -1, dtype=torch.int32, device=dev)
    wide[0] = 0
    h_wide = sm.sparse_wave_histogram(store, root_lid, w3, wide, B, F,
                                      exps=exps)
    need(torch.equal(h_wide[0], hist[0]) and bool((h_wide[1:] == 0).all()),
         "B6's one-slot root differs from the 32-slot call with slot 0 "
         "active")
    del hist, h_wide
    say("B6 equals B3 on every non-fill cell to the bit, at K = 32 and at "
        "the root (and in the bf16 form at K = 32); the root's one slot "
        "gives the 32-slot call's bits")
    return rec, rec_bf16


def fill_bias_reading(store, labels, num_bins, sm):
    """The bf16 offset of the rebuilt fill bins, read at the root on the
    sparse booster's first-iteration weights (binary logloss from the
    label mean p: g = p - y, h = p (1 - p)).  The sparse path rebuilds a
    column's fill bin as the leaf's unrounded sum minus its other bins,
    which B6 sums from rounded weights; so beside the fill bin that the
    rounded weights would give, each column's rebuilt fill bin holds
    offset = (unrounded leaf sum) - (rounded leaf sum), the whole leaf's
    rounding, whatever the column.  Returns the reading (B6 launches:
    the root at K = 1, unrounded and bf16)."""
    import torch

    from lightgbm_tpu_torch.ops import wave_kernels as wk
    dev = store.ent_row.device
    F, B = store.num_cols, num_bins
    y = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    p = float(y.double().mean())
    w3 = torch.stack([p - y, torch.full_like(y, p * (1 - p)),
                      torch.ones_like(y)], dim=1).contiguous()
    exps = wk.fixed_point_exponents(w3)
    lid = torch.zeros(y.shape[0], dtype=torch.int32, device=dev)
    cid = torch.zeros(1, dtype=torch.int32, device=dev)
    h_un = sm.sparse_wave_histogram(store, lid, w3, cid, B, F, exps=exps)
    h_bf = sm.sparse_wave_histogram(store, lid, w3, cid, B, F, exps=exps,
                                    hilo=False)
    nf_un = h_un[0].double().sum(dim=1)          # (F, 3) non-fill sums
    nf_bf = h_bf[0].double().sum(dim=1)
    leaf = w3.double().sum(dim=0)
    leaf_r = wk.round_bf16(w3).double().sum(dim=0)
    offset = leaf - leaf_r
    # each rebuilt fill bin's error against its true (unrounded) sum
    fill_err = (nf_un - nf_bf)[:, :2].abs().max(dim=0).values
    # the column's own signal: its non-fill gradient sum
    signal = nf_un[:, 0].abs()
    r = dict(p=p, leaf_g=float(leaf[0]), leaf_h=float(leaf[1]),
             offset_g=float(offset[0]), offset_h=float(offset[1]),
             abs_g=float(w3[:, 0].double().abs().sum()),
             fill_err_g=float(fill_err[0]), fill_err_h=float(fill_err[1]),
             median_signal_g=float(signal.median()),
             cols_offset_over_signal=int((signal < abs(float(offset[0])))
                                         .sum()), cols=F)
    need(all(np.isfinite(v) for v in r.values()),
         "fill-bin reading not finite: %s" % r)
    return r


def structure(booster, with_thresholds=False):
    keys = ("split_feature", "left_child", "right_child", "leaf_count")
    if with_thresholds:
        keys += ("threshold=",)
    return [ln for ln in booster.model_to_string().splitlines()
            if ln.startswith(keys)]


def small_sparse_run_matches(lgb, bf16=False):
    """A small sparse run on the card (kernel B6) grows the trees the CPU
    grows (compared as small_run_matches_cpu compares them) and the trees
    the port's dense path grows on the card from the same data: the same
    partitions, leaf values to 5e-4 of the largest (the dense path sums
    the default bin directly, the sparse path rebuilds it as the leaf sum
    minus the other bins; tests/test_torch_sparse_train.py says more).
    bf16: under tpu_hist_precision=bf16, against the CPU only (the dense
    root is unrounded, the sparse root B6's, rounded)."""
    import scipy.sparse as sps
    rng = np.random.default_rng(0)
    n = 2500
    X = np.where(rng.random((n, 12)) < 0.2, rng.normal(size=(n, 12)), 0.0)
    X[:, 0] = rng.normal(size=n)
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.4 * X[:, 9]
         + 0.3 * rng.normal(size=n) > 0).astype(float)
    C = sps.csr_matrix(X)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
         "tpu_wave_width": 4, "tpu_sparse": True, "tpu_sparse_kernel": True,
         "tpu_hist_precision": "bf16" if bf16 else "auto"}
    dense_p = {k: v for k, v in p.items() if not k.startswith("tpu_sparse")}
    card = lgb.train(p, lgb.Dataset(C, label=y), 3, device="cuda")
    cpu = lgb.train(p, lgb.Dataset(C, label=y), 3, device="cpu")
    need(structure(card) == structure(cpu),
         "small sparse run: trees differ from the CPU's")
    need(np.allclose(card.predict(C), cpu.predict(C), rtol=1e-5, atol=0),
         "small sparse run: predictions differ from the CPU's")
    if bf16:
        return
    dense = lgb.train(dense_p, lgb.Dataset(X, label=y), 3, device="cuda")
    need(structure(card) == structure(dense),
         "small sparse run: trees differ from the dense path's")
    lv = [np.array(ln.split("=")[1].split(), float)
          for b in (card, dense) for ln in b.model_to_string().splitlines()
          if ln.startswith("leaf_value")]
    half = len(lv) // 2
    a, b = np.concatenate(lv[:half]), np.concatenate(lv[half:])
    need(np.abs(a - b).max() <= 5e-4 * np.abs(b).max(),
         "small sparse run: leaf values differ from the dense path's")


def sparse_phase(args, lgb, sm, kernels, card):
    """Phase 5: B6 at the Bosch store, then sparse training on it.
    Returns (B6's record, the run's launch counts, the bf16 form's record
    and launches, and (Dataset, valid Dataset, the fused run's model
    text, the store's device bytes) for phase 14a)."""
    import torch
    t0 = time.perf_counter()
    Xs, ys = make_sparse_data(args.sparse_rows, 7)
    Xsv, ysv = make_sparse_data(VALID_ROWS, 8)
    t_csr = time.perf_counter() - t0
    params = sparse_params()
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xs, label=ys, params=params).construct()
    dv = lgb.Dataset(Xsv, label=ysv, reference=ds).construct()
    t_bin = time.perf_counter() - t0
    td = ds._handle
    from lightgbm_tpu_torch.ops.sparse_store import column_fill_bins
    ncols = (td.bundle.num_groups if td.bundle is not None
             else td.num_features)
    nbins = (int(td.bundle.num_group_bins.max()) if td.bundle is not None
             else int(td.num_bin_arr.max()))
    t0 = time.perf_counter()
    store, nbytes = sm.build_chunked_store(
        td.binned, column_fill_bins(td.num_bin_arr, td.default_bin_arr,
                                    td.bundle), nbins, auto_uniform=True,
        device="cuda")
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    say("sparse data: %d train rows, %d valid rows, %d columns, %d nonzeros "
        "(%.4f%%), %d used features, %d device columns, %d bins max, "
        "bundles %s; set-up: CSR %.2f s, binning %.2f s, store %.2f s "
        "(%d chunks of %d entries, cap %d, %.1f MB on the device)"
        % (Xs.shape[0], Xsv.shape[0], Xs.shape[1], Xs.nnz,
           100.0 * Xs.nnz / (Xs.shape[0] * Xs.shape[1]), td.num_features,
           ncols, nbins, td.bundle is not None, t_csr, t_bin, t_store,
           store.ent_bin.shape[0], store.ent_bin.shape[1], store.cap_chunks,
           nbytes / 1e6))
    need(Xs.shape[1] == SPARSE_COLS and td.num_features > 900,
         "unexpected sparse binning")
    record, record_bf16 = sparse_kernel_phase(store, Xs.shape[0], nbins, sm,
                                              args.sweep)
    fill = fill_bias_reading(store, ys, nbins, sm)
    say("sparse bf16 fill-bin reading at the root (first-iteration "
        "weights, p = %.6f): leaf sums g %.6f, h %.6f; unrounded minus "
        "rounded leaf sum (each rebuilt fill bin's offset) g %.6f, h %.6f "
        "(sum |g| %.3f); largest error of a rebuilt fill bin against its "
        "true sum g %.6f, h %.6f; median |non-fill g sum| of a column "
        "%.6f; %d of %d columns have |non-fill g sum| below |offset g|"
        % (fill["p"], fill["leaf_g"], fill["leaf_h"], fill["offset_g"],
           fill["offset_h"], fill["abs_g"], fill["fill_err_g"],
           fill["fill_err_h"], fill["median_signal_g"],
           fill["cols_offset_over_signal"], fill["cols"]))
    del store
    torch.cuda.empty_cache()

    # ---- the sparse main path: lightgbm_tpu_torch.train on the store,
    # fused (auto on the card), then staged in the same call
    runs = {}
    for label, chain_params in (
            ("sparse", params),
            ("sparse-staged", dict(params, tpu_fused_iter="off"))):
        stamps = []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        evals = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        booster, launches = counted(kernels, lambda: lgb.train(
            chain_params, ds, ITERS, valid_sets=[dv], evals_result=evals,
            callbacks=[stamp]))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        learner = booster._gbdt.learner
        stats = booster.grow_stats()
        trees = len(stats)
        waves = sum(s.passes for s in stats)
        reads = sum(s.host_reads for s in stats)
        say("%s train launches: %s; %d trees, %d waves, histogram cache %s"
            % (label, launches, trees, waves, learner.cache_hists))
        need(learner.hist_mode == "sparse_mxu", "sparse run did not take "
             "the sparse store (%s)" % learner.hist_mode)
        need(trees == ITERS, "%s: grew %d trees, wanted %d"
             % (label, trees, ITERS))
        need((fused_of(booster) is None) == label.endswith("staged"),
             "%s: took the other chain" % label)
        check_wave_launches(label, booster, launches, stats,
                            "sparse_wave_histogram")
        auc = evals["valid_0"]["auc"][-1]
        need(auc > 0.8, "%s valid AUC %.4f <= 0.8" % (label, auc))
        AUCS[label] = auc
        steady = ((len(stamps) - 1) / (stamps[-1] - stamps[0])
                  if len(stamps) > 1 else float("nan"))
        say("%s train on %s: %d iterations in %.3f s including set-up "
            "(%.4f it/s); steady %.4f it/s over iterations 2-%d; %.2f "
            "waves/tree, %.2f host reads/tree, leaves/tree %s, depth %s; "
            "valid AUC %.6f; peak device memory %.2f GB"
            % (label, card, ITERS, t_train, ITERS / t_train, steady, ITERS,
               waves / trees, reads / trees, [s.num_leaves for s in stats],
               [s.depth for s in stats], auc,
               torch.cuda.max_memory_allocated() / 1e9))
        chain_line(label, booster, stats)
        runs[label] = (booster, launches)
        if args.profile:
            profile_iteration(booster, card)
    need(runs["sparse"][0].model_to_string()
         == runs["sparse-staged"][0].model_to_string(),
         "sparse: fused and staged model texts differ")
    say("sparse: fused and staged model text equal to the byte")
    booster, launches = runs.pop("sparse")
    del runs
    raw_dev = booster._gbdt.valid_score_host(0)[0]
    raw_host = host_raw(booster, Xsv)
    need(raw_host.shape == (Xsv.shape[0],) and np.isfinite(raw_host).all(),
         "sparse valid predictions not finite or of the wrong shape")
    need(np.allclose(raw_dev, raw_host, rtol=1e-5, atol=1e-5),
         "sparse: device valid scores differ from host trees (max %g)"
         % np.abs(raw_dev - raw_host).max())
    again = lgb.Booster(model_str=booster.model_to_string())
    need(np.array_equal(again.predict(Xsv[:1000]),
                        booster.predict(Xsv[:1000])),
         "sparse: model text round trip changed predictions")
    small_sparse_run_matches(lgb)
    say("sparse checks: device scores match host trees; model text round "
        "trip; small sparse run on the card matches the CPU and the dense "
        "path")
    # ---- phase 10e: bf16 boosters on the same Dataset (no second
    # binning), fused then staged (the same text to the byte): every B6
    # launch, the root's included, a bf16 one; the valid AUC is printed
    # beside the unrounded run's (on this skewed data bf16 costs AUC, in
    # the JAX package's semantics too: tests/test_torch_bf16.py; the
    # fill-bin reading above), and a small bf16 run on the card grows
    # the CPU's trees
    evals = {}
    (bf, bf_launches), forms = counted_forms(kernels, lambda: counted(
        kernels, lambda: lgb.train(dict(params, tpu_hist_precision="bf16"),
                                   ds, ITERS, valid_sets=[dv],
                                   evals_result=evals)))
    stats = bf.grow_stats()
    check_wave_launches("sparse-bf16", bf, bf_launches, stats,
                        "sparse_wave_histogram")
    need(forms["sparse_wave_histogram_bf16"]
         == bf_launches["sparse_wave_histogram"],
         "sparse-bf16: B6 launches not all bf16: %s" % forms)
    auc = evals["valid_0"]["auc"][-1]
    auc_hilo = AUCS["sparse"]
    need(auc > 0.8, "sparse-bf16 valid AUC %.4f <= 0.8" % auc)
    need(bf.model_to_string() != booster.model_to_string(),
         "sparse-bf16: the unrounded run's text (no rounding?)")
    need(fused_of(bf) is not None, "sparse-bf16: did not run fused")
    staged, st_launches = counted(kernels, lambda: lgb.train(
        dict(params, tpu_hist_precision="bf16", tpu_fused_iter="off"), ds,
        ITERS))
    check_wave_launches("sparse-bf16-staged", staged, st_launches,
                        staged.grow_stats(), "sparse_wave_histogram")
    need(fused_of(staged) is None, "sparse-bf16-staged: ran fused")
    # the fused run evaluated a valid set and the staged one none: their
    # drift_fingerprint= lines' eval snapshots differ, the rest must not
    need(without_fp(staged.model_to_string())
         == without_fp(bf.model_to_string()),
         "sparse-bf16: fused and staged model texts differ")
    del staged
    small_sparse_run_matches(lgb, bf16=True)
    say("sparse-bf16 launches: %s, forms %s; staged launches %s; fused "
        "and staged model text equal to the byte; valid AUC %.6f, the "
        "unrounded run's %.6f (difference %.2e; the acceptance bound "
        "is 1e-3, unmet on this data); %d and %d waves in all; a small bf16 "
        "sparse run on the card grows the CPU's trees"
        % (bf_launches, forms, st_launches, auc, auc_hilo, auc - auc_hilo,
           sum(s.passes for s in stats),
           sum(s.passes for s in booster.grow_stats())))
    return (record, launches, record_bf16, forms,
            (ds, dv, booster.model_to_string(),
             booster._gbdt.learner.sparse_device_bytes))


def profile_iteration(booster, card):
    """One more iteration under torch.profiler: its wall time, waves (or
    splits under exact growth) and host reads, the device's busy share
    and the device time by kernel, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fused = fused_of(booster)
    replays = fused.replays if fused is not None else 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if fused is not None:
        replays = fused.replays - replays
    rows, launches = [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
        launches += e.count
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    k = booster.num_model_per_iteration()
    last = booster.grow_stats()[-k:]
    passes = sum(s.passes for s in last)
    unit = ("split" if booster._gbdt.learner.growth == "exact"
            else "wave")
    say("profile of one %s iteration (%d tree%s) on %s: wall %.4f s, %d "
        "%ss, %d host reads, device busy %.4f s (%.1f%%, idle %.1f%%), %d "
        "device operations (%.0f a %s), %d graph replays"
        % ("fused" if fused is not None else "staged", k,
           "s" if k > 1 else "", card, wall, passes, unit,
           sum(s.host_reads for s in last), busy, 100 * busy / wall,
           100 - 100 * busy / wall, launches, launches / max(passes, 1),
           unit, replays))
    for us, count, key in rows[:12]:
        say("  %9.3f ms %6d  %s" % (us / 1e3, count, key[:100]))
    # the port's own kernels, wherever they rank
    for us, count, key in rows[12:]:
        if "anonymous namespace)::" in key and "at::" not in key:
            say("  %9.3f ms %6d  %s" % (us / 1e3, count, key[:100]))


def small_run_matches_cpu(lgb, variants, rounds=3):
    """A small run through the kernels grows the trees the plain versions
    grow on the CPU: the same split features, child pointers and leaf
    counts, and the same predictions on the training rows to rtol 1e-5
    ((N, K) for multiclass).  Threshold values are not compared: where
    the best split borders an empty bin (the zero bin of a feature
    without zeros), two scan passes reach the same partition with gains
    equal up to rounding, and the histograms' summation order picks one
    of the two equivalent bins.  Each variant's params are laid over the
    wave-grown binary recipe; its objective picks the labels (classes
    for multiclass, the score itself for the regression losses, its
    absolute value for Poisson).  The binary variants' predictions are
    held to rtol 1e-5 alone; the others' also to 1e-5 of the largest
    output."""
    rng = np.random.default_rng(10)
    X = rng.normal(size=(2000, 10))
    s = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 9]
         + 0.1 * rng.normal(size=2000))
    keys = ("split_feature", "left_child", "right_child", "leaf_count")
    for v in variants:
        p = dict({"objective": "binary", "num_leaves": 15,
                  "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
                  "tpu_growth": "wave"}, **v)
        obj = p["objective"]
        y = (np.digitize(s, [-0.6, 0.6]).astype(float)
             if obj.startswith("multiclass")
             else (s > 0).astype(float) if obj == "binary"
             else np.abs(s) if obj == "poisson" else s)
        a = lgb.train(p, lgb.Dataset(X, label=y), rounds, device="cuda")
        b = lgb.train(p, lgb.Dataset(X, label=y), rounds, device="cpu")
        sa = [ln for ln in a.model_to_string().splitlines()
              if ln.startswith(keys)]
        sb = [ln for ln in b.model_to_string().splitlines()
              if ln.startswith(keys)]
        need(len(sa) > 0 and sa == sb,
             "small run %s: trees differ from the CPU's" % v)
        pa, pb = a.predict(X), b.predict(X)
        # raw regression outputs pass through 0, where a relative bound
        # alone fails: there 1e-5 of the largest output
        atol = 0.0 if obj == "binary" else 1e-5 * np.abs(pb).max()
        need(np.allclose(pa, pb, rtol=1e-5, atol=atol),
             "small run %s: predictions differ from the CPU's" % v)


def goss_matches_cpu(lgb, rounds=6):
    """GOSS (learning_rate 0.5: no sampling before iteration 2) on
    small_run_matches_cpu's data, on the card and on the CPU: the trees
    before sampling and the tree of the first sampled iteration are the
    CPU's (the same partitions of the rows they weigh), that iteration
    keeps the same rows with the same multipliers, and those rows
    predict the same after it (rtol 1e-5).  Left-out rows weigh 0, so a
    bin holding only them is empty to the split search and either
    threshold of such a gap may win on rounding: a left-out row may then
    fall in another leaf on the card than on the CPU, and from the next
    sample on the runs may part.  The later iterations' agreement is
    printed, not required."""
    rng = np.random.default_rng(10)
    X = rng.normal(size=(2000, 10))
    y = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 9]
         + 0.1 * rng.normal(size=2000) > 0).astype(float)
    p = {"objective": "binary", "boosting": "goss", "learning_rate": 0.5,
         "num_leaves": 15, "min_data_in_leaf": 20, "max_bin": 63,
         "verbose": -1, "tpu_growth": "wave"}
    keys = ("split_feature", "left_child", "right_child", "leaf_count")
    runs = []
    for device in ("cuda", "cpu"):
        mults = []

        def keep(env):
            m = env.model._gbdt.row_mult
            mults.append(None if m is None else m.cpu().numpy())
        b = lgb.train(p, lgb.Dataset(X, label=y), rounds, device=device,
                      callbacks=[keep])
        text = b.model_to_string()
        trees = [[ln for ln in blk.splitlines() if ln.startswith(keys)]
                 for blk in text.split("Tree=")[1:]]
        runs.append((b, mults, trees))
    (card, mc, tc), (cpu, mp, tcpu) = runs
    first = int(1.0 / p["learning_rate"])
    need(all(m is None for m in mc[:first] + mp[:first]),
         "small GOSS run: sampled before iteration %d" % first)
    need(mc[first] is not None and np.array_equal(mc[first], mp[first]),
         "small GOSS run: the first sample's rows differ from the CPU's")
    need(tc[:first + 1] == tcpu[:first + 1],
         "small GOSS run: trees through the first sample differ from the "
         "CPU's")
    kept = mc[first] > 0
    need(np.allclose(card.predict(X[kept], num_iteration=first + 1),
                     cpu.predict(X[kept], num_iteration=first + 1),
                     rtol=1e-5, atol=0),
         "small GOSS run: the kept rows predict differently from the CPU")
    same = next((i for i, (a, b) in enumerate(zip(tc, tcpu)) if a != b),
                len(tc))
    samples = sum(a is not None and b is not None and np.array_equal(a, b)
                  for a, b in zip(mc, mp))
    say("small GOSS run (%d iterations, %d rows kept at iteration %d): the "
        "trees through the first sample and its rows are the CPU's; %d of "
        "%d trees and %d of %d samples agree over the whole run"
        % (rounds, int(kept.sum()), first + 1, same, len(tc), samples,
           rounds - first))


def fused_of(booster):
    """The booster's FusedIteration, or None on the staged chain."""
    state = booster._gbdt._fused_state
    return None if state is None else state[0]


def launched_passes(booster, stats):
    """The masked passes a run launched: a fused tree runs its tree
    graph's passes (M waves, or S gated splits) and its tail passes, a
    staged tree the passes that split."""
    fused = fused_of(booster)
    if fused is None:
        return sum(s.passes for s in stats)
    return sum(fused.passes + s.tail_passes for s in stats)


def chain_line(label, booster, stats):
    """Print which chain a run took and, when fused, its graph set-up
    (capture seconds), replays and the trees that needed tail graphs
    (graph_memory prints the graphs' memory)."""
    fused = fused_of(booster)
    if fused is None:
        say("%s chain: staged, %d host reads over %d trees"
            % (label, sum(s.host_reads for s in stats), len(stats)))
        return
    tails = [s.tail_passes for s in stats]
    unit = ("gated splits" if booster._gbdt.learner.growth == "exact"
            else "masked waves")
    say("%s chain: fused, %d %s in the tree graph and %d in a tail graph; "
        "graph capture %.3f s (set-up); %d graph "
        "replays; %d of %d trees finished within the tree graph, %d needed "
        "tail graphs (%d tail passes, %.2f a tree); %d host reads over %d "
        "trees (%.2f a tree)"
        % (label, fused.passes, unit, fused.tail_len, fused.capture_seconds,
           fused.replays,
           sum(t == 0 for t in tails), len(stats), sum(t > 0 for t in tails),
           sum(tails), sum(tails) / len(stats),
           sum(s.host_reads for s in stats), len(stats),
           sum(s.host_reads for s in stats) / len(stats)))
    need(all(s.host_reads == 1 + s.tail_passes // fused.tail_len
             for s in stats),
         "%s: a fused tree made more than one host read plus one a tail "
         "graph" % label)


def graph_memory(label, booster):
    """Print the device memory of a fused run's CUDA graphs and of the
    state they replay on, then drop the graphs (the booster still
    predicts; a further iteration would capture anew).  The graphs'
    memory is their private pools: the reserved memory that deleting
    them gives back, the allocator's cache emptied before and after.
    The state is every tensor the iteration allocated before capturing,
    the list passes' workspace among them."""
    import dataclasses
    import gc
    import torch
    fused = fused_of(booster)
    if fused is None:
        return
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    fused._tree = fused._tail = fused._score = None
    gc.collect()
    torch.cuda.empty_cache()
    pools = held - torch.cuda.memory_reserved()
    st = fused.state
    tensors = [getattr(st.tree, f.name) for f in dataclasses.fields(st.tree)]
    tensors += [getattr(st, f.name) for f in dataclasses.fields(st)
                if f.name != "tree"]
    tensors += [fused.w3, fused.exps, fused.row_mult, fused.feature_mask]
    state = sum(t.numel() * t.element_size() for t in tensors
                if t is not None)
    work = 0 if st.work is None else st.work.numel() * 8
    say("%s graph memory: %.4f GB in the graphs' pools (%d passes in the "
        "tree graph, %d in a tail graph); the state they replay on %.4f GB, "
        "of it the list passes' workspace %.4f GB"
        % (label, pools / 1e9, fused.passes, fused.tail_len, state / 1e9,
           work / 1e9))


def check_wave_launches(label, booster, launches, stats, kernel,
                        updates=ITERS):
    """The launch counts of a wave-growth run: with kernel
    'wave_partition_hist' (the main path), B1 once a wave pass and B3
    once a tree (and once a wave pass for the larger children without
    the histogram cache); with a histogram-only kernel (B3, B4 or B6),
    that kernel once a tree and once a wave pass (twice without the
    cache); no other histogram kernel; B2 `updates` times: once an
    iteration, or once a tree where an iteration grows K."""
    trees, passes = len(stats), launched_passes(booster, stats)
    extra = 0 if booster._gbdt.learner.cache_hists else passes
    want = dict.fromkeys(("wave_partition_hist", "wave_histogram",
                          "wave_histogram_rowmajor", "leaf_histogram",
                          "sparse_wave_histogram"), 0)
    if kernel == "wave_partition_hist":
        want.update(wave_partition_hist=passes,
                    wave_histogram=trees + extra)
    else:
        want[kernel] = trees + passes + extra
    want["score_update"] = updates
    need(passes > 0 and {k: launches[k] for k in want} == want,
         "%s: launches %s, wanted %s (%d trees, %d wave passes)"
         % (label, launches, want, trees, passes))


def check_exact_launches(label, booster, launches, stats, updates=ITERS):
    """The launch counts of an exact-growth run: B5 once a tree for the
    root and once a split pass (twice without the histogram cache): the
    splits that committed when staged, every gated split of the tree
    graph and the tail graphs when fused; no other histogram kernel; B2
    once an iteration."""
    passes = launched_passes(booster, stats)
    per_split = 1 if booster._gbdt.learner.cache_hists else 2
    want = dict.fromkeys(("wave_partition_hist", "wave_histogram",
                          "wave_histogram_rowmajor", "sparse_wave_histogram"),
                         0)
    want["leaf_histogram"] = len(stats) + per_split * passes
    want["score_update"] = updates
    need(all(s.passes == s.num_leaves - 1 for s in stats),
         "%s: a tree's split count is not its leaves less one" % label)
    need(passes > 0 and {k: launches[k] for k in want} == want,
         "%s: launches %s, wanted %s (%d trees, %d split passes)"
         % (label, launches, want, len(stats), passes))
    # B5's device operations: its plan's a call (the one-scan kernel and
    # its conversion)
    import torch

    from lightgbm_tpu_torch.ops import leaf_hist as lh
    learner = booster._gbdt.learner
    grower = learner.exact_grower()
    plan = lh.leaf_plan(grower.hist_cols, grower.hist_bins,
                        learner.dtype == torch.float64)
    per = lh.plan_launches(plan)
    got = DEVICE_LAUNCHES.get("leaf_histogram")
    need(got == per * want["leaf_histogram"],
         "%s: B5's device operations %s, wanted %d a call (plan %s)"
         % (label, got, per, tuple(plan)))
    say("%s: B5 %d calls, %d device operations (%d a call, plan %s)"
        % (label, want["leaf_histogram"], got, per, tuple(plan)))


def small_exact_order_runs(lgb):
    """Exact-order waves at W = 32 on the pallas_t and row-major dataflows
    (the flagship recipe on 20,000 rows, 63 leaves) and on the sparse
    store (the Bosch-shaped recipe on 20,000 rows), fused and staged,
    train their own W = 1 model text to the byte."""
    X, y = make_data(20_000)
    Xs, ys = make_sparse_data(20_000, 7)
    for flow, (Xf, yf), more in (
            ("pallas_t", (X, y), {"tpu_histogram_mode": "pallas_t"}),
            ("pallas", (X, y), {"tpu_histogram_mode": "pallas"}),
            ("sparse", (Xs, ys), {"tpu_sparse": True,
                                  "tpu_sparse_kernel": True})):
        p = dict(flagship_params(), num_leaves=63, **more)
        ds = lgb.Dataset(Xf, label=yf, params=p).construct()
        texts, waves = [], []
        for extra in ({"tpu_wave_order": "exact"},
                      {"tpu_wave_order": "exact", "tpu_fused_iter": "off"},
                      {"tpu_wave_width": 1}):
            b = lgb.train(dict(p, **extra), ds, 3)
            need(fused_of(b) is None
                 or extra.get("tpu_fused_iter") != "off",
                 "small exact-order %s: took the other chain" % flow)
            texts.append(b.model_to_string())
            waves.append(sum(s.passes for s in b.grow_stats()) / 3)
        need(texts[0] == texts[1] == texts[2],
             "small exact-order %s run: model text differs from W = 1's"
             % flow)
        say("small exact-order %s run: fused and staged at W = 32 equal "
            "W = 1 to the byte; %.2f waves a tree (W = 1: %.2f)"
            % (flow, waves[0], waves[2]))


def staged_twin(label, params, text, data, lgb, kernels, card, args):
    """The run of params on the staged chain (tpu_fused_iter=off), in the
    same call: its model text must equal the fused run's to the byte."""
    booster, launches, stats = dense_train_phase(
        label + "-staged", dict(params, tpu_fused_iter="off"), data, lgb,
        kernels, card, args)
    need(fused_of(booster) is None, "%s-staged: ran fused" % label)
    need(booster.model_to_string() == text,
         "%s: fused and staged model texts differ" % label)
    say("%s: fused and staged model text equal to the byte" % label)
    return booster, launches, stats


# the device operations of the wrappers that count them (B5's
# device_launches) over the last counted() run
DEVICE_LAUNCHES = {}


def counted(kernels, fn):
    """fn() with every kernel's launch count set to 0 just before; returns
    (fn's result, {kernel: its launches during fn}).  The device
    operations of the wrappers that count them land in DEVICE_LAUNCHES."""
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "device_launches"):
            k.device_launches = 0
    out = fn()
    DEVICE_LAUNCHES.clear()
    DEVICE_LAUNCHES.update({name: k.device_launches
                            for name, k in kernels.items()
                            if hasattr(k, "device_launches")})
    return out, {name: k.launches for name, k in kernels.items()}


def dense_train_phase(label, params, data, lgb, kernels, card, args,
                      updates=ITERS):
    """One training run on the flagship data through
    lightgbm_tpu_torch.train, every launch counter set to 0 just before
    and read just after, with phase 4's checks of what comes out (and,
    with --profile, one more iteration profiled after them); B2 must
    launch `updates` times (0 where the gather engine updates the
    scores).  Returns (booster, launches, the run's GrowStats)."""
    import torch
    ds, dv, Xt_raw, Xv, _ = data
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    evals = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    booster, launches = counted(kernels, lambda: lgb.train(
        params, ds, ITERS, valid_sets=[dv], evals_result=evals,
        callbacks=[stamp]))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    learner = booster._gbdt.learner
    stats = list(booster.grow_stats())
    trees = len(stats)
    passes = sum(s.passes for s in stats)
    reads = sum(s.host_reads for s in stats)
    unit = "splits" if learner.growth == "exact" else "waves"
    say("%s train launches: %s; %d trees, %d %s; growth %s, histogram mode "
        "%s, histogram cache %s" % (label, launches, trees, passes, unit,
                                    learner.growth, learner.hist_mode,
                                    learner.cache_hists))
    need(trees == ITERS, "%s: grew %d trees, wanted %d"
         % (label, trees, ITERS))
    need(launches["score_update"] == updates,
         "%s: B2 launches %d, wanted %d"
         % (label, launches["score_update"], updates))
    auc = evals["valid_0"]["auc"][-1]
    need(auc > 0.8, "%s: valid AUC %.4f <= 0.8" % (label, auc))
    AUCS[label] = auc
    steady = ((len(stamps) - 1) / (stamps[-1] - stamps[0])
              if len(stamps) > 1 else float("nan"))
    RATES[label] = (ITERS / t_train, steady)
    say("%s train on %s: %d iterations in %.3f s including set-up (%.4f "
        "it/s); steady %.4f it/s over iterations 2-%d; %.2f %s/tree, %.2f "
        "host reads/tree, leaves/tree %s, depth %s; valid AUC %.6f; peak "
        "device memory %.2f GB"
        % (label, card, ITERS, t_train, ITERS / t_train, steady, ITERS,
           passes / trees, unit, reads / trees,
           [s.num_leaves for s in stats], [s.depth for s in stats], auc,
           torch.cuda.max_memory_allocated() / 1e9))

    chain_line(label, booster, stats)

    check_scores_follow_trees(label, booster, Xt_raw, Xv)
    again = lgb.Booster(model_str=booster.model_to_string())
    need(np.array_equal(again.predict(Xv[:1000]), booster.predict(Xv[:1000])),
         "%s: model text round trip changed predictions" % label)
    if args.profile:
        profile_iteration(booster, card)
    graph_memory(label, booster)
    return booster, launches, stats


def multiclass_labels(*parts, classes=CLASSES):
    """Covertype's class count on the flagship features: for the rows of
    each part in turn, the argmax over `classes` of X @ W * 0.5 + 0.5 *
    noise, W (28 x classes) drawn as bench.py draws its w (normal, 30%
    zeroed), the noise normal, both from default_rng(43)."""
    rng = np.random.default_rng(43)
    f = parts[0].shape[1]
    W = rng.normal(size=(f, classes)) * (rng.random((f, classes)) > 0.3)
    out = []
    for X in parts:
        y = np.empty(len(X), np.float64)
        for lo in range(0, len(X), 500_000):
            part = X[lo:lo + 500_000]
            y[lo:lo + len(part)] = np.argmax(
                part @ W * 0.5
                + 0.5 * rng.normal(size=(len(part), classes)), axis=1)
        out.append(y)
    return out


def mode_phase(label, params, iters, data, lgb, kernels, card, metric,
               k=1, watch=None):
    """One staged run of a boosting mode or of multiclass on full-width
    data through lightgbm_tpu_torch.train, every launch counter set to 0
    just before and read just after: its valid metric at each
    iteration, steady (iterations 2+) and whole-call rate, trees/s, B1,
    B3 and B2 launches a tree (checked as check_wave_launches checks
    them, B2 once a tree), and waves and host reads a tree.  watch(env)
    returns a line to print after each iteration.  Returns (booster,
    launches, stats, the metric's values)."""
    import torch
    ds, dv = data[0], data[1]
    stamps, notes = [], []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if watch is not None:
            notes.append(watch(env))

    evals = {}
    t0 = time.perf_counter()
    booster, launches = counted(kernels, lambda: lgb.train(
        params, ds, iters, valid_sets=[dv], evals_result=evals,
        callbacks=[stamp], verbose_eval=False))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    stats = list(booster.grow_stats())
    trees = len(stats)
    need(fused_of(booster) is None,
         "%s: fused (multiclass and the boosting modes stay staged)" % label)
    need(trees == iters * k, "%s: grew %d trees, wanted %d"
         % (label, trees, iters * k))
    check_wave_launches(label, booster, launches, stats,
                        "wave_partition_hist", updates=trees)
    values = evals["valid_0"][metric]
    need(len(values) == iters and np.isfinite(values).all(),
         "%s: valid %s not finite at every iteration" % (label, metric))
    steady = ((len(stamps) - 1) / (stamps[-1] - stamps[0])
              if len(stamps) > 1 else float("nan"))
    RATES[label] = (iters / t_train, steady)
    learner = booster._gbdt.learner
    say("%s train on %s: %d iterations, %d trees in %.3f s including "
        "set-up (%.4f it/s, %.4f trees/s); steady %.4f it/s (%.4f trees/s) "
        "over iterations 2-%d; wave order %s, W = %d; %.2f waves/tree, "
        "%.2f host reads/tree; launches a tree: B1 %.2f, B3 %.2f, B2 %.2f; "
        "peak device memory %.2f GB"
        % (label, card, iters, trees, t_train, iters / t_train,
           trees / t_train, steady, steady * k, iters, learner.wave_order,
           learner.wave_width, sum(s.passes for s in stats) / trees,
           sum(s.host_reads for s in stats) / trees,
           launches["wave_partition_hist"] / trees,
           launches["wave_histogram"] / trees,
           launches["score_update"] / trees,
           torch.cuda.max_memory_allocated() / 1e9))
    say("%s valid %s by iteration: %s" % (
        label, metric, " ".join("%.6f" % v for v in values)))
    for i, note in enumerate(notes):
        if note:
            say("%s iteration %d: %s" % (label, i + 1, note))
    return booster, launches, stats, values


def host_raw(booster, X):
    """Raw predictions of the host trees in float64 (tpu_predict=false):
    (N,) for one tree an iteration, else (N, K)."""
    cfg = booster._gbdt.config
    mode, cfg.tpu_predict = cfg.tpu_predict, "false"
    try:
        return booster.predict(X, raw_score=True)
    finally:
        cfg.tpu_predict = mode


def check_scores_follow_trees(label, booster, Xt_raw, Xv, k=1):
    """The device valid scores and the train scores (B2's) equal the
    host trees' raw predictions, (N,) or (N, k), finite (rtol and atol
    1e-5; the first CHECK_ROWS valid and train rows)."""
    mv = min(len(Xv), CHECK_ROWS)
    raw_dev = booster._gbdt.valid_score_host(0)[:, :mv]
    raw_host = host_raw(booster, Xv[:mv])
    need(raw_host.shape == ((mv, k) if k > 1 else (mv,))
         and np.isfinite(raw_host).all(),
         "%s: valid predictions not finite or of the wrong shape" % label)
    raw_host = raw_host.reshape(mv, k)
    need(np.allclose(raw_dev.T, raw_host, rtol=1e-5, atol=1e-5),
         "%s: device valid scores differ from host trees (max %g)"
         % (label, np.abs(raw_dev.T - raw_host).max()))
    m = min(len(Xt_raw), CHECK_ROWS)
    train_dev = booster._gbdt.train_score[:, :m].T
    need(np.allclose(train_dev, host_raw(booster, Xt_raw[:m]).reshape(m, k),
                     rtol=1e-5, atol=1e-5),
         "%s: device train scores differ from host trees" % label)


def multiclass_phase(args, lgb, kernels, card, ds, Xt_raw, Xv):
    """Softmax with 7 classes on the flagship features (the first
    CUT_ROWS of --rows), staged:
    35 trees through B3, B1 and B2 (B2 into row tid of the (7, N)
    score); multi_logloss falls every iteration; the model text reloads
    through convert.booster_from_model_string and predicts the same
    (N, 7) probabilities to 1e-6.  The Datasets are binned with the
    flagship's mappers (the features are the same)."""
    import torch
    from lightgbm_tpu_torch.convert import booster_from_model_string
    t0 = time.perf_counter()
    Xt_raw = Xt_raw[:CUT_ROWS]
    y, yv = multiclass_labels(Xt_raw, Xv)
    dm = lgb.Dataset(Xt_raw, label=y, reference=ds)
    dmv = dm.create_valid(Xv, label=yv)
    dm.construct()
    dmv.construct()
    counts = np.bincount(dm.get_label().astype(int), minlength=CLASSES)
    say("multiclass data: %d train rows, %d valid rows, classes %s "
        "(%.1f s)" % (len(Xt_raw), len(Xv), counts.tolist(),
                      time.perf_counter() - t0))
    params = dict(flagship_params(), objective="multiclass",
                  num_class=CLASSES, metric="multi_logloss,multi_error")
    booster, launches, stats, values = mode_phase(
        "multiclass", params, ITERS, (dm, dmv), lgb, kernels, card,
        "multi_logloss", k=CLASSES)
    need(launches["score_update"] == CLASSES * ITERS,
         "multiclass: B2 launches %d != %d"
         % (launches["score_update"], CLASSES * ITERS))
    need(all(a > b for a, b in zip(values, values[1:])),
         "multiclass: valid multi_logloss did not fall every iteration")
    check_scores_follow_trees("multiclass", booster, Xt_raw, Xv,
                              k=CLASSES)
    prob = booster.predict(Xv)
    again = booster_from_model_string(booster.model_to_string())
    need(prob.shape == (len(Xv), CLASSES)
         and np.allclose(again.predict(Xv), prob, rtol=0, atol=1e-6),
         "multiclass: model text round trip changed the probabilities")
    say("multiclass checks: B2 launches %d (%d trees); multi_logloss falls "
        "every iteration; device scores match host trees; model text "
        "reloads to the same (N, %d) probabilities"
        % (launches["score_update"], len(stats), CLASSES))
    if args.profile:
        profile_iteration(booster, card)
    del booster, dm, dmv
    torch.cuda.empty_cache()
    return launches


def boosting_modes_phase(lgb, kernels, card, data):
    """DART, GOSS and InfiniteBoost on the flagship recipe at --rows,
    staged, with exact-order waves (tpu_wave_order=auto resolves them so
    for these modes): the launches a tree as the main path's, valid AUC
    above 0.8, and, for DART and GOSS, device scores equal to the host
    trees (InfiniteBoost's scores are the capped contributions it trains
    on, not its final tree weights).  DART prints the trees it drops
    each iteration, GOSS the rows it keeps."""
    import torch
    _, _, Xt_raw, Xv, _ = data
    base = flagship_params()

    def drops(env):
        return "dropped %s" % env.model._gbdt.drop_index

    def kept(env):
        m = env.model._gbdt.row_mult
        return ("kept every row (no sampling before iteration %d)"
                % int(1.0 / base["learning_rate"]) if m is None
                else "kept %d rows" % int(m.sum()))

    out = {}
    for label, more, iters, watch in (
            ("dart", {"boosting": "dart", "drop_rate": 0.1,
                      "drop_seed": 4}, 10, drops),
            ("goss", {"boosting": "goss", "top_rate": 0.2,
                      "other_rate": 0.1}, 15, kept),
            ("infiniteboost", {"boosting": "infinite", "capacity": 50},
             5, None)):
        booster, launches, stats, auc = mode_phase(
            label, dict(base, **more), iters, data, lgb, kernels, card,
            "auc", watch=watch)
        need(booster._gbdt.learner.wave_order == "exact",
             "%s: did not resolve to exact-order waves" % label)
        need(auc[-1] > 0.8, "%s: valid AUC %.4f <= 0.8" % (label, auc[-1]))
        if label != "infiniteboost":
            check_scores_follow_trees(label, booster, Xt_raw, Xv)
        out[label] = launches
        del booster
        torch.cuda.empty_cache()
    say("boosting mode checks: staged, exact-order waves, launches a tree "
        "as the main path's, valid AUC above 0.8; DART and GOSS device "
        "scores match host trees")
    return out


def early_stopping_phase(lgb, card):
    """The flagship recipe on 20,000 rows with a valid set of 20,000,
    early_stopping_rounds=5, up to 200 rounds.  On the flagship's own
    metric, AUC, it is printed where it stopped, if it did; on the valid
    binary_logloss it must stop before 200 with best_iteration set, keep
    every tree, and predict(num_iteration=best_iteration) must equal a
    fresh run of best_iteration rounds to 1e-6."""
    X, y = make_data(40_000)
    Xv = X[20_000:]
    ds = lgb.Dataset(X[:20_000], label=y[:20_000], params=flagship_params())
    dv = ds.create_valid(Xv, label=y[20_000:])
    for metric in ("auc", "binary_logloss"):
        params = dict(flagship_params(), metric=metric)
        t0 = time.perf_counter()
        booster = lgb.train(params, ds, 200, valid_sets=[dv],
                            early_stopping_rounds=5, verbose_eval=False)
        took = time.perf_counter() - t0
        best = booster.best_iteration
        ran = booster.current_iteration()
        say("early stopping on %s, valid %s: %s after %d of 200 iterations "
            "in %.3f s (%s), best_iteration %d, best %s %.6f"
            % (card, metric, "stopped" if best > 0 else "did not stop",
               ran, took, "fused" if fused_of(booster) is not None
               else "staged", best, metric,
               booster.best_score["valid_0"][metric]))
    need(1 <= best and ran == best + 5 < 200,
         "early stopping: ran %d iterations, best_iteration %d"
         % (ran, best))
    fresh = lgb.train(params, ds, best, verbose_eval=False)
    need(np.allclose(booster.predict(Xv, num_iteration=best),
                     fresh.predict(Xv), rtol=0, atol=1e-6),
         "early stopping: predict(num_iteration=best_iteration) differs "
         "from a fresh run of best_iteration rounds")
    say("early stopping checks: stopped before 200 on binary_logloss with "
        "every tree kept; predict at best_iteration equals a fresh "
        "%d-round run" % best)


def make_serve_data(rows, fresh):
    """bench_serve.py build_model's recipe (:41-51): default_rng(11), 28
    normal features drawn as float32, w normal, y = (X @ w > 0); then
    ``fresh`` more rows of the same recipe from the same generator, and
    their labels."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(rows, 28)).astype(np.float32)
    w = rng.normal(size=28)
    y = (X @ w > 0).astype(np.float64)
    Xf = rng.normal(size=(fresh, 28)).astype(np.float32)
    yf = (Xf @ w > 0).astype(np.float64)
    return np.asarray(X, np.float64), y, np.asarray(Xf, np.float64), yf


def run_load(sp, X, requests, threads, sizes, seed=5, raw=False):
    """bench_serve.py run_load's closed loop: each thread submits
    ``requests // threads`` blocks of a size drawn from ``sizes`` at a
    random offset and waits for each (raw scores when ``raw``).  Returns
    (latencies, wall_s, rows, [(lo, n, response)])."""
    import threading
    lat = [[] for _ in range(threads)]
    got = [[] for _ in range(threads)]
    per = max(requests // threads, 1)

    def worker(i):
        rng = np.random.default_rng(seed + i)
        for _ in range(per):
            n = int(rng.choice(sizes))
            lo = int(rng.integers(0, max(X.shape[0] - n, 1)))
            t0 = time.perf_counter()
            out = sp.submit(X[lo:lo + n], raw_score=raw).result()
            lat[i].append(time.perf_counter() - t0)
            got[i].append((lo, n, out))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    done = [r for g in got for r in g]
    return (np.concatenate([np.asarray(x) for x in lat]), wall,
            sum(n for _, n, _ in done), done)


def profile_replay(sp, X, card):
    """One replay of the top bucket's converted graph under
    torch.profiler: wall time, busy share and device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cache = sp.cache
    bucket = cache.max_batch
    V, D = cache.encode(cache.normalize(X[:bucket]))
    spans = {}
    cache.run_encoded(V, D, bucket, True, spans)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cache.run_encoded(V, D, bucket, True, spans)
        wall = time.perf_counter() - t0
    busy, ops, rows = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        busy += us / 1e6
        ops += e.count
        rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    say("profile of one %d-row serving replay (copy in, graph, copy out) "
        "on %s: wall %.6f s, device busy %.6f s (%.1f%%, idle %.1f%%), %d "
        "device operations" % (bucket, card, wall, busy, 100 * busy / wall,
                               100 - 100 * busy / wall, ops))
    for us, count, key in rows[:8]:
        say("  %9.3f ms %6d  %s" % (us / 1e3, count, key[:100]))


def serve_phase(args, lgb, card, dev):
    """Phase 7: prediction and serving at bench_serve.py's full shape:
    200,000 rows x 28 features, binary, 255 leaves, max_bin 63, 100
    rounds, trained fused on the card.  7a bulk prediction of 2,000,000
    fresh rows under tpu_predict=auto (the device path), a 200,000-row
    slice held against the host trees (raw within rtol 2e-6 and atol
    2e-6; leaf indices of the ranked traversal equal to
    Tree.predict_leaf_index); 7b the model text loaded with
    device="cuda" predicts the same raw scores to the bit; 7c
    booster.serve(max_batch=4096, max_delay_ms=2.0), the bucket ladder
    64..4096 captured raw and converted, then bench_serve.py's closed
    loop (8 threads, 5,000 requests of {1, 8, 32, 100, 256, 512, 1024}
    rows, seed 5) over the 200,000 rows of 7a: no steady-state capture,
    no shed, every request on the device route, every response equal to
    the same rows served alone and within 2e-6 of the host trees; one
    request each on the es and contrib routes equal to Booster.predict.
    The model's 200,000 training rows are binned as bench_serve.py bins
    them (through the port's host library).  Returns (X, y, the 200,000
    fresh rows of 7a and their labels, the model text) for phase 8."""
    import gc
    import torch
    from lightgbm_tpu_torch.ops import predict as tp
    t_phase = time.perf_counter()
    X, y, Xb, yb = make_serve_data(SERVE_ROWS, BULK_ROWS)
    params = {"objective": "binary", "num_leaves": SERVE_LEAVES,
              "max_bin": 63, "verbose": -1}
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    booster = lgb.train(params, lgb.Dataset(X, label=y), SERVE_ROUNDS,
                        device=dev, callbacks=[stamp])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    need(fused_of(booster) is not None, "serve model: did not train fused")
    gbdt = booster._gbdt
    gbdt._materialize()
    depths = [t.depth() for t in gbdt.models]
    say("serve model on %s: %d trees trained fused in %.3f s including "
        "binning and set-up, steady %.4f it/s over iterations 2-%d (%d "
        "rows, %d leaves max, depth %d max, %.2f mean)"
        % (card, len(gbdt.models), t_train,
           (len(stamps) - 1) / (stamps[-1] - stamps[0]), SERVE_ROUNDS,
           SERVE_ROWS, max(t.num_leaves for t in gbdt.models), max(depths),
           float(np.mean(depths))))

    # ---- 7a. bulk prediction on the device (tpu_predict=auto)
    walks = [0]
    real_walk = tp.ranked_predict

    def counted(*a, **k):
        walks[0] += 1
        return real_walk(*a, **k)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    tp.ranked_predict = counted
    try:
        t0 = time.perf_counter()
        raw_dev = booster.predict(Xb, raw_score=True)
        dev_s = time.perf_counter() - t0
    finally:
        tp.ranked_predict = real_walk
    peak = torch.cuda.max_memory_allocated() - base_mem
    k_rows = gbdt._predict_chunk_rows(Xb.shape[1], min(len(gbdt.models),
                                                        gbdt._TREE_BLOCK))
    chunks = -(-BULK_ROWS // k_rows)
    need(walks[0] == chunks and raw_dev.shape == (BULK_ROWS,)
         and np.isfinite(raw_dev).all(),
         "7a: the device path did not run (%d traversals) or its output "
         "is not finite" % walks[0])
    # the split: the host encoding of the first chunk, and the traversal
    # alone on that chunk's encoded rows already on the card (CUDA events)
    rp = tp.build_ranked_predictor(gbdt.models, 1, Xb.shape[1], dev)
    t0 = time.perf_counter()
    V, D = tp.rank_encode(rp, Xb[:k_rows])
    enc_s = time.perf_counter() - t0
    Vd, Dd = torch.as_tensor(V, device=dev), torch.as_tensor(D, device=dev)
    walk_ms = time_ms(lambda: tp.ranked_predict(rp.dev, Vd, Dd,
                                                gbdt._TREE_BLOCK),
                      reps=2, groups=3, warmup=1)
    del Vd, Dd
    # the host trees: Booster.predict under tpu_predict=false times the
    # host path on 20,000 rows; on the 200,000-row slice its f64 sum is
    # taken, in the same tree order, from the host leaf indices that the
    # device's are held against
    t0 = time.perf_counter()
    host_raw(booster, Xb[:20_000])
    host_s = time.perf_counter() - t0
    sl = slice(0, SERVE_ROWS)
    host_leaves = booster.predict(Xb[sl], pred_leaf=True)
    raw_host = np.zeros(SERVE_ROWS)
    for t, tree in enumerate(gbdt.models):
        if tree.num_leaves > 1:
            raw_host += tree.leaf_value[host_leaves[:, t]]
    need(np.array_equal(raw_host[:20_000], host_raw(booster, Xb[:20_000])),
         "7a: the f64 sum of the host leaves is not tpu_predict=false's")
    err = np.abs(raw_dev[sl] - raw_host)
    need(np.all(err <= 2e-6 + 2e-6 * np.abs(raw_host)),
         "7a: device raw scores differ from the host trees (max %g)"
         % err.max())
    V, D = tp.rank_encode(rp, Xb[sl])
    leaves = tp.ranked_leaf_indices(rp.dev, torch.as_tensor(V, device=dev),
                                    torch.as_tensor(D, device=dev)).cpu()
    need(np.array_equal(leaves.numpy(), host_leaves),
         "7a: device leaf indices differ from Tree.predict_leaf_index")
    say("7a bulk predict on %s: %d rows on the device path in %.3f s (%.0f "
        "rows/s; %d chunks of %d rows, peak device memory %.4f GB above "
        "the model); a chunk's host encode %.3f s and its traversal on "
        "the card %.3f ms (so %.3f s of encode and %.3f s of device time "
        "for all rows); host trees (tpu_predict=false) %.0f rows/s on "
        "20,000 rows; against them on %d rows: raw max abs err %.3g, leaf "
        "indices of %d x %d equal"
        % (card, BULK_ROWS, dev_s, BULK_ROWS / dev_s, chunks, k_rows,
           peak / 1e9, enc_s, walk_ms, enc_s * BULK_ROWS / k_rows,
           walk_ms / 1e3 * BULK_ROWS / k_rows, 20_000 / host_s, SERVE_ROWS,
           err.max(), SERVE_ROWS, len(gbdt.models)))

    # ---- 7b. the model text, loaded on the card
    loaded = lgb.Booster(model_str=booster.model_to_string(), device=dev)
    need(loaded.device.type == dev.type, "7b: loaded booster not on the card")
    t0 = time.perf_counter()
    raw_loaded = loaded.predict(Xb, raw_score=True)
    load_s = time.perf_counter() - t0
    need(np.array_equal(raw_loaded, raw_dev),
         "7b: the loaded model's device scores differ from the trained "
         "booster's")
    say("7b loaded from model text on %s: %d rows in %.3f s, raw scores "
        "equal to the trained booster's device path to the bit"
        % (loaded.device, BULK_ROWS, load_s))
    del loaded, raw_loaded, raw_dev
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7c. serving, on the 200,000 fresh rows 7a held against the host
    # trees (bench_serve.py serves its training rows; these are rows of
    # the same recipe whose host scores are already known)
    X_train, X = X, Xb[sl]
    conv_host = gbdt.objective.convert_output(raw_host)
    sp = booster.serve(max_batch=SERVE_MAX_BATCH, max_delay_ms=2.0)
    try:
        ladder = [1 << b for b in range(6, 13)]           # 64 .. 4096
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        sp.cache.warmup(ladder, convert=False)
        need(sp.warmup(ladder) == ladder, "7c: warm-up ladder")
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        graphs = torch.cuda.memory_reserved() - held
        static = sum(2 * b * (28 * 5 + 4) for b in ladder)
        st = sp.stats()["executables"]
        need(st["graphs"] == st["compiles"] == 2 * len(ladder),
             "7c: expected %d captured graphs, got %s"
             % (2 * len(ladder), st))
        say("7c serve warm-up on %s: %d graphs (buckets %s, raw and "
            "converted) captured in %.3f s; device memory %.4f GB reserved "
            "by them (their inputs and outputs %.4f GB, the rest their "
            "shared pool)" % (card, st["graphs"], ladder, cap_s,
                              graphs / 1e9, static / 1e9))
        lat, wall, rows, done = run_load(sp, X, SERVE_REQUESTS,
                                         SERVE_THREADS, SERVE_SIZES)
        st = sp.stats()
        p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
        say("7c serving on %s: %d requests (%d rows) from %d threads in "
            "%.3f s: p50 %.6f s, p99 %.6f s, %.1f requests/s, %.0f rows/s; "
            "%d batches, %d pad rows, %d shed, steady-state captures %d"
            % (card, len(lat), rows, SERVE_THREADS, wall, p50, p99,
               len(lat) / wall, rows / wall, st["batches"], st["pad_rows"],
               st["shed_total"], st["executables"]["steady_state_compiles"]))
        need(st["executables"]["steady_state_compiles"] == 0,
             "7c: a graph was captured after warm-up")
        need(st["shed_total"] == 0, "7c: requests were shed")
        need(st["routes"] == {"dev": SERVE_REQUESTS}
             and len(done) == SERVE_REQUESTS,
             "7c: routes %s, %d responses" % (st["routes"], len(done)))
        worst = 0.0
        t0 = time.perf_counter()
        for lo, n, out in done:
            need(out.shape == (n,) and np.array_equal(
                sp.predict(X[lo:lo + n]), out),
                "7c: a response differs from the same rows served alone")
            worst = max(worst, float(np.abs(out - conv_host[lo:lo + n]).max()))
        solo_s = time.perf_counter() - t0
        need(worst <= 2e-6, "7c: responses differ from the host trees by "
             "%g" % worst)
        es_kw = {"pred_early_stop": True, "pred_early_stop_freq": 5,
                 "pred_early_stop_margin": 4.0}
        need(np.array_equal(sp.predict(X[:300], **es_kw),
                            booster.predict(X[:300], **es_kw)),
             "7c: the es route differs from Booster.predict")
        need(np.array_equal(sp.predict(X[:300], pred_contrib=True),
                            booster.predict(X[:300], pred_contrib=True)),
             "7c: the contrib route differs from Booster.predict")
        st = sp.stats()
        need(st["routes"] == {"dev": 2 * SERVE_REQUESTS, "es": 1,
                              "contrib": 1}
             and st["executables"]["steady_state_compiles"] == 0,
             "7c: routes after the solo checks %s" % st["routes"])
        say("7c checks: every response equal to its rows served alone "
            "(%d solo requests in %.3f s), max %.3g from the host trees; es "
            "and contrib routes equal to Booster.predict; no capture after "
            "warm-up" % (len(done), solo_s, worst))
        if args.profile:
            profile_replay(sp, X, card)
    finally:
        sp.close()
    # ---- 14d. the same booster and rows, served without an observer
    # and with the run observer, drift monitoring and the live plane
    serve_observer_phase(lgb, card, booster, X)
    say("phase 7 (prediction and serving): %.1f s"
        % (time.perf_counter() - t_phase))
    return (X_train, y, Xb[:SERVE_ROWS].copy(), yb[:SERVE_ROWS].copy(),
            booster.model_to_string())


def auc(y, score):
    """Area under the ROC curve (ties counted half), from the ranks."""
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    ranks = np.empty(len(s))
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[i:j + 1] = (i + j) / 2.0 + 1
        i = j + 1
    r = np.empty(len(s))
    r[order] = ranks
    pos = y > 0
    n1, n0 = pos.sum(), (~pos).sum()
    return float((r[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def write_tsv(path, X, y):
    """Label first, then the features, each printed with %.17g (glibc's
    strtod and Python's float read the same float64 back)."""
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter="\t")


def cli_args(params, **more):
    kv = dict(params, **more)
    return ["%s=%s" % (k, v) for k, v in kv.items()]


def file_phase(lgb, kernels, card, data):
    """Phase 8: the file path on the card, on phase 7's data (the first
    FILE_ROWS x 28 training rows of bench_serve.py's recipe and as many
    fresh rows with their labels) at the flagship's params (binary, 255
    leaves, max_bin 63, wave growth, W = 32, fused under auto).

    8a the rows written as TSV (label first, %.17g); 8b ``python -m
    lightgbm_tpu_torch task=train`` (5 iterations, the fresh rows as valid
    data) in a subprocess on the card, whose model text must equal an
    in-process lightgbm_tpu_torch.train on the same arrays, to the byte;
    8c Dataset.construct() of the first FALLBACK_ROWS rows through the
    host library and through the Python fallback: equal bins and bin
    bounds; 8d
    task=predict on the fresh rows (the device path under auto), its
    file equal, text for text, to Booster.predict printed with %.9g; 8e
    input_model= plus 5 rounds through the CLI: 10 trees, scores starting
    from the base model's predict_raw(allow_device=False), valid AUC at
    least the base model's less 1e-3; 8f checkpoint_dir with
    checkpoint_every=2, 3 rounds then 5: the second run trains 2 rounds,
    ends with 5 trees, its first 3 the first run's; 8g the host trees
    (predict_raw(allow_device=False)) of phase 7's 100-tree model on the
    first FALLBACK_ROWS fresh rows through the host library and the
    Python loop: equal sums, and their rows/s.  Every launch counter is set to 0 before each
    in-process run and read after; returns the phase's launches."""
    import shutil
    import tempfile

    import torch
    from lightgbm_tpu_torch import cli, native
    from lightgbm_tpu_torch.io import parser
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.ops import predict as tp
    t_phase = time.perf_counter()
    X, y, Xf, yf, serve_model = data
    X, y, Xf, yf = X[:FILE_ROWS], y[:FILE_ROWS], Xf[:FILE_ROWS], yf[:FILE_ROWS]
    params = flagship_params()
    total = {name: 0 for name in kernels}

    def add(got):
        for name, n in got.items():
            total[name] += n

    work = tempfile.mkdtemp(prefix="chip_smoke_files_")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        tr, va = os.path.join(work, "train.tsv"), os.path.join(work,
                                                              "valid.tsv")
        t0 = time.perf_counter()
        write_tsv(tr, X, y)
        write_tsv(va, Xf, yf)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = parser.parse_file(tr)
        parse_s = time.perf_counter() - t0
        need(np.array_equal(parsed.features, X)
             and np.array_equal(parsed.label, y),
             "8a: the parsed TSV is not the float64 rows written")
        del parsed

        # ---- 8b. the CLI trains in a subprocess on the card
        model = os.path.join(work, "cli.txt")
        env = dict(os.environ, PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
             "data=" + tr, "valid_data=" + va, "num_iterations=5",
             "output_model=" + model] + cli_args(params), env=env,
            cwd=work, capture_output=True, text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        need(run.returncode == 0, "8b: python -m lightgbm_tpu_torch "
             "task=train failed:\n%s" % run.stderr[-4000:])
        text = open(model).read()
        t0 = time.perf_counter()
        booster, got = counted(kernels, lambda: lgb.train(
            params, lgb.Dataset(X, label=y), 5,
            valid_sets=[lgb.Dataset(Xf, label=yf)], verbose_eval=False))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        add(got)
        need(fused_of(booster) is not None, "8b: train did not run fused")
        # the CLI writes GBDT's model text, as the JAX package's CLI does;
        # model_to_string adds the Python API's pandas_categorical line
        # both carry a drift_fingerprint= line, each its own: the CLI's
        # samples parsed text and names its valid set valid_1, train's
        # valid_0 (as in the JAX package); the rest equal to the byte
        got = booster._gbdt.save_model_to_string()
        need("\ndrift_fingerprint=" in got
             and "\ndrift_fingerprint=" in text,
             "8b: a model text lacks its drift_fingerprint= line")
        need(without_fp(got) == without_fp(text),
             "8b: the CLI's model text differs from lightgbm_tpu_torch.train"
             "'s on the same arrays")
        say("8b on %s: python -m lightgbm_tpu_torch task=train (5 "
            "iterations, %d rows from TSV) took %.3f s in its "
            "subprocess; its model text equals lightgbm_tpu_torch.train's "
            "(%.3f s in-process, fused) to the byte; launches %s"
            % (card, len(y), cli_s, train_s, got))

        # ---- 8c. binning through the host library and the fallback, on
        # the first FALLBACK_ROWS rows
        Xc, yc = X[:FALLBACK_ROWS], y[:FALLBACK_ROWS]
        t0 = time.perf_counter()
        nat = lgb.Dataset(Xc, label=yc, params=params).construct()._handle
        nat_s = time.perf_counter() - t0
        with native.disabled():
            t0 = time.perf_counter()
            py = lgb.Dataset(Xc, label=yc, params=params).construct()._handle
            py_s = time.perf_counter() - t0
        need(nat.binned.tobytes() == py.binned.tobytes(),
             "8c: native and fallback bins differ")
        need(all(np.array_equal(a.bin_upper_bound, b.bin_upper_bound)
                 for a, b in zip(nat.bin_mappers, py.bin_mappers)),
             "8c: native and fallback bin bounds differ")
        del nat, py

        # ---- 8d. task=predict on the fresh rows (the device path)
        out = os.path.join(work, "pred.txt")
        walks = [0]
        real_walk = tp.ranked_predict

        def walk(*a, **k):
            walks[0] += 1
            return real_walk(*a, **k)

        tp.ranked_predict = walk
        try:
            t0 = time.perf_counter()
            cli.main(["task=predict", "input_model=" + model, "data=" + va,
                      "output_result=" + out, "verbose=-1"])
            pred_s = time.perf_counter() - t0
        finally:
            tp.ranked_predict = real_walk
        need(walks[0] > 0, "8d: task=predict did not take the device path")
        want = "".join("%.9g\n" % v for v in booster.predict(Xf))
        need(open(out).read() == want,
             "8d: the predict file differs from Booster.predict (%%.9g)")
        base_auc = auc(yf, booster.predict(Xf, raw_score=True))

        # ---- 12b. the same files through the CLI in two rounds
        # (use_two_round_loading: io/streaming.py, the train file and the
        # valid file on the train file's mappers): 8b's model text and
        # 8d's predict file
        from lightgbm_tpu_torch.io import streaming
        model2 = os.path.join(work, "two_round.txt")
        out2 = os.path.join(work, "pred2.txt")
        streams = [0]
        real_stream = streaming.stream_load

        def stream(*a, **k):
            streams[0] += 1
            return real_stream(*a, **k)

        streaming.stream_load = stream
        try:
            t0 = time.perf_counter()
            _, got = counted(kernels, lambda: cli.main(
                ["task=train", "data=" + tr, "valid_data=" + va,
                 "num_iterations=5", "use_two_round_loading=true",
                 "output_model=" + model2] + cli_args(params)))
            two_s = time.perf_counter() - t0
        finally:
            streaming.stream_load = real_stream
        PHASE12["cli-two-round"] = got
        need(streams[0] == 2, "12b: %d files streamed, not the train and "
             "valid files" % streams[0])
        need(open(model2).read() == text, "12b: the two-round CLI run's "
             "model text differs from 8b's")
        cli.main(["task=predict", "input_model=" + model2, "data=" + va,
                  "output_result=" + out2, "verbose=-1"])
        need(open(out2).read() == open(out).read(),
             "12b: the two-round model's predict file differs from 8d's")
        say("12b on %s: the CLI with use_two_round_loading=true (train and "
            "valid TSV streamed) took %.3f s in-process; model text equal "
            "to 8b's and predict file equal to 8d's; launches %s"
            % (card, two_s, got))

        # ---- 8e. continued training through the CLI
        seen = {}
        real_reset = GBDT.reset_training_data

        def spy(self, *a, **k):
            real_reset(self, *a, **k)
            if self.models:
                seen["score"] = self.train_score[0].copy()

        more = os.path.join(work, "more.txt")
        GBDT.reset_training_data = spy
        try:
            _, got = counted(kernels, lambda: cli.main(
                ["task=train", "data=" + tr, "valid_data=" + va,
                 "num_iterations=5", "input_model=" + model,
                 "output_model=" + more] + cli_args(params)))
        finally:
            GBDT.reset_training_data = real_reset
        add(got)
        base = lgb.Booster(model_file=model)
        init = base._gbdt.predict_raw(X, allow_device=False)[:, 0]
        need(np.array_equal(seen.get("score"), init.astype(np.float32)
                            .astype(np.float64)),
             "8e: the continued run's scores do not start from the base "
             "model's predict_raw(allow_device=False)")
        cont = lgb.Booster(model_file=more)
        need(cont.num_trees() == 10, "8e: %d trees after 5 + 5"
             % cont.num_trees())
        cont_auc = auc(yf, cont.predict(Xf, raw_score=True))
        need(cont_auc >= base_auc - 1e-3, "8e: valid AUC %.6f after "
             "continuing, %.6f before" % (cont_auc, base_auc))
        say("8e continued training through the CLI: 10 trees, the scores "
            "from the base model's f64 host trees, valid AUC %.6f -> %.6f; "
            "launches %s" % (base_auc, cont_auc, got))

        # ---- 8f. checkpoint resume through the CLI
        ck = ["task=train", "data=" + tr, "checkpoint_dir="
              + os.path.join(work, "ck"), "checkpoint_every=2"]
        _, got = counted(kernels, lambda: cli.main(
            ck + ["num_iterations=3", "output_model="
                  + os.path.join(work, "a.txt")] + cli_args(params)))
        add(got)
        iters = [0]
        real_iter = GBDT.train_one_iter

        def count_iter(self, *a, **k):
            iters[0] += 1
            return real_iter(self, *a, **k)

        GBDT.train_one_iter = count_iter
        try:
            _, got = counted(kernels, lambda: cli.main(
                ck + ["num_iterations=5", "output_model="
                      + os.path.join(work, "b.txt")] + cli_args(params)))
        finally:
            GBDT.train_one_iter = real_iter
        add(got)
        a = open(os.path.join(work, "a.txt")).read()
        b = open(os.path.join(work, "b.txt")).read()

        def trees(text):
            body = text.split("\nfeature importances")[0]
            return [t.strip() for t in body.split("Tree=")[1:]]

        need(iters[0] == 2, "8f: the resumed run trained %d rounds, not 2"
             % iters[0])
        need(len(trees(b)) == 5 and trees(b)[:3] == trees(a),
             "8f: the resumed model is not the first run's 3 trees and 2 "
             "more")

        # ---- 8g. the host trees of phase 7's model, native and Python,
        # on the first FALLBACK_ROWS fresh rows
        big = lgb.Booster(model_str=serve_model)._gbdt
        Xg = Xf[:FALLBACK_ROWS]
        t0 = time.perf_counter()
        raw_n = big.predict_raw(Xg, allow_device=False)
        nat_rows = len(Xg) / (time.perf_counter() - t0)
        with native.disabled():
            t0 = time.perf_counter()
            raw_p = big.predict_raw(Xg, allow_device=False)
            py_rows = len(Xg) / (time.perf_counter() - t0)
        need(np.array_equal(raw_n, raw_p),
             "8g: native and Python host trees differ")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    need(total["wave_partition_hist"] > 0 and total["wave_histogram"] > 0
         and total["score_update"] > 0,
         "phase 8: a kernel of the path did not launch: %s" % total)
    say("phase 8 seconds on %s: TSV write %.3f (2 x %d rows), parse "
        "%.3f (%d x 29, Python), binning %.3f native and %.3f Python "
        "fallback (Dataset.construct, %d x 28), training %.3f "
        "(in-process, 5 iterations); CLI train subprocess %.3f; CLI predict "
        "%.3f; host trees (predict_raw(allow_device=False), phase 7's %d "
        "trees, %d rows) %.0f rows/s native, %.0f rows/s Python"
        % (card, write_s, len(y), parse_s, len(y), nat_s, py_s, len(Xc),
           train_s, cli_s,
           pred_s, len(big.models), len(Xg), nat_rows, py_rows))
    say("phase 8 launches: %s" % total)
    say("phase 8 (files and the CLI): %.1f s" % (time.perf_counter()
                                                  - t_phase))
    return total


# ---------------------------------------------------------------- phase 9
def guide_source(name, replacement, work):
    """examples/python-guide/<name>.py with its one line ``import
    lightgbm_tpu as lgb`` replaced and its GUIDE_TMP prefix made the
    directory ``work`` (so no other run of the examples shares its
    files); fails unless the line is there exactly once, or if an
    example of GUIDE_WRITES_TMP holds no GUIDE_TMP path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "python-guide", name + ".py")
    with open(path) as f:
        lines = f.read().split("\n")
    at = [i for i, ln in enumerate(lines) if ln == GUIDE_IMPORT]
    need(len(at) == 1, "9a: %s holds %r %d times" % (name, GUIDE_IMPORT,
                                                      len(at)))
    lines[at[0]] = replacement
    src = "\n".join(lines)
    need(name not in GUIDE_WRITES_TMP or GUIDE_TMP in src,
         "9a: %s holds no %r path" % (name, GUIDE_TMP))
    return src.replace(GUIDE_TMP, os.path.join(work, ""))


def guide_phase(card):
    """9a: the four python-guide examples on the port, on the card (the
    default device): each written to a temporary directory with
    ``import lightgbm_tpu_torch as lgb`` and run in its own process, the
    four at once; each must exit 0 with output.  One exception, printed:
    plot_example is not run where matplotlib is not installed (it exits
    1 by its own check without it), as on the card's machine so far;
    ROADMAP A6 keeps its card run queued.  Returns the examples run."""
    import importlib.util
    import shutil
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="guide_")
    env = dict(os.environ, PYTHONPATH=root, MPLBACKEND="Agg")
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in GUIDE_EXAMPLES:
            if (name == "plot_example"
                    and importlib.util.find_spec("matplotlib") is None):
                say("9a plot_example: NOT RUN on %s: matplotlib is not "
                    "installed on this machine and the example exits 1 "
                    "without it; its card run stays queued (ROADMAP A6), "
                    "tier-1 runs it on the CPU" % card)
                continue
            path = os.path.join(work, "port_%s.py" % name)
            with open(path, "w") as f:
                f.write(guide_source(name, "import lightgbm_tpu_torch as lgb",
                                     work))
            procs[name] = subprocess.Popen(
                [sys.executable, path], cwd=work, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            secs = time.perf_counter() - t0
            need(proc.returncode == 0 and out.strip(),
                 "9a: %s exited %s on the card:\n%s"
                 % (name, proc.returncode, err[-3000:]))
            last = out.strip().splitlines()[-1]
            say("9a %s on %s: exit 0 after %.1f s (the four started "
                "together); last line: %s" % (name, card, secs, last))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return sorted(procs)


def make_ranking(n_queries, seed, w=None, cuts=None):
    """Ranking data at MSLR-WEB10K's published shape: query lengths
    lognormal with mean RANK_MEAN_DOCS (sigma 1), clipped to
    [1, RANK_MAX_DOCS]; 136 normal float32 features; labels 0-4 cut from
    a hidden linear score plus noise at RANK_SHARES (the cuts and w of a
    training set are reused for its valid set).  Returns (X, y, query
    lengths, w, cuts)."""
    rng = np.random.default_rng(seed)
    sigma = 1.0
    lengths = np.clip(np.rint(rng.lognormal(
        np.log(RANK_MEAN_DOCS) - sigma * sigma / 2, sigma, n_queries)),
        1, RANK_MAX_DOCS).astype(np.int64)
    n = int(lengths.sum())
    X = rng.standard_normal((n, RANK_FEATURES), dtype=np.float32)
    if w is None:
        w = (rng.normal(size=RANK_FEATURES)
             * (rng.random(RANK_FEATURES) > 0.5)).astype(np.float32)
        w /= np.sqrt(max(1, int((w != 0).sum())))
    score = X @ w + np.float32(0.6) * rng.standard_normal(n, np.float32)
    if cuts is None:
        cuts = np.quantile(score, np.cumsum(RANK_SHARES)[:-1])
    y = np.searchsorted(cuts, score, side="right").astype(np.float64)
    return X, y, lengths, w, cuts


def ranking_params():
    """examples/lambdarank/train.conf's params (max_bin at its default
    255)."""
    return {"objective": "lambdarank", "num_leaves": 31,
            "learning_rate": 0.1, "metric": "ndcg", "ndcg_eval_at": [1, 3, 5],
            "verbose": -1}


def ranking_phase(lgb, kernels, card, seed):
    """9b: lambdarank at MSLR-WEB10K's shape (synthetic, from --seed),
    5 iterations fused then staged, equal model text; B3 builds every
    wave's histograms (136 x 256 bins is past the ct bound); the
    gradients on the card against the host oracle at full size; NDCG@5
    rising; then (9d) LGBMRanker on the same data trains the same model
    text.  Returns the phase's launches."""
    import gc
    import torch
    total = {name: 0 for name in kernels}

    def add(got):
        for name, n in got.items():
            total[name] += n

    t0 = time.perf_counter()
    X, y, q, w, cuts = make_ranking(RANK_QUERIES, seed)
    Xv, yv, qv, _, _ = make_ranking(RANK_VALID_QUERIES, seed + 1, w, cuts)
    gen_s = time.perf_counter() - t0
    shares = np.bincount(y.astype(int), minlength=5) / len(y)
    say("9b ranking data (seed %d): %d queries, %d documents (query length "
        "mean %.1f, max %d), %d features; valid %d queries, %d documents; "
        "label shares 0-4 %s; made in %.1f s"
        % (seed, len(q), len(y), len(y) / len(q), q.max(), X.shape[1],
           len(qv), len(yv), " ".join("%.4f" % v for v in shares), gen_s))
    params = ranking_params()
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, group=q, params=params).construct()
    bin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dv = lgb.Dataset(Xv, label=yv, group=qv, reference=ds).construct()
    vbin_s = time.perf_counter() - t0
    td = ds._handle
    say("9b binning: %.1f s (%d x %d, %d bins max), valid %.1f s"
        % (bin_s, td.num_data, td.num_features, int(td.num_bin_arr.max()),
           vbin_s))
    texts = {}
    for label, mode in (("ranking", "auto"), ("ranking-staged", "off")):
        stamps = []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        evals = {}
        t0 = time.perf_counter()
        booster, got = counted(kernels, lambda: lgb.train(
            dict(params, tpu_fused_iter=mode), ds, ITERS, valid_sets=[dv],
            evals_result=evals, callbacks=[stamp], verbose_eval=False))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        add(got)
        learner = booster._gbdt.learner
        stats = booster.grow_stats()
        steady = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        ndcg = {k: evals["valid_0"]["ndcg@%d" % k] for k in (1, 3, 5)}
        say("%s on %s: launches %s; growth %s, wave order %s, histogram "
            "mode %s; %d iterations in %.3f s including set-up, steady "
            "%.4f it/s over iterations 2-%d; leaves/tree %s"
            % (label, card, got, learner.growth, learner.wave_order,
               learner.hist_mode, ITERS, t_train, steady, ITERS,
               [s.num_leaves for s in stats]))
        for k in (1, 3, 5):
            say("%s valid NDCG@%d by iteration: %s" % (
                label, k, " ".join("%.6f" % v for v in ndcg[k])))
        need(learner.hist_mode == "pallas_t" and got["wave_histogram"] > 0
             and got["score_update"] == ITERS,
             "%s: B3 did not build the waves' histograms (%s, %s)"
             % (label, learner.hist_mode, got))
        need(ndcg[5][-1] > ndcg[5][0],
             "%s: NDCG@5 did not rise (%s)" % (label, ndcg[5]))
        chain_line(label, booster, stats)
        texts[label] = booster.model_to_string()
        if mode == "auto":
            need(fused_of(booster) is not None, "ranking: did not run fused")
            obj = booster._gbdt.objective
            score = booster._gbdt._score_dev[0]
            say("ranking objective: %d buckets (widths %s), pairwise block "
                "tensors of %.1f MB at the largest bucket"
                % (len(obj._buckets),
                   [int(b["discounts"].numel()) for b in obj._buckets],
                   obj.pair_block_bytes() / 1e6))
            dev_ms = time_ms(lambda: obj.get_gradients(score), reps=3,
                             groups=3, warmup=1)
            g, h = (a.cpu().numpy() for a in obj.get_gradients(score))
            t0 = time.perf_counter()
            gh, hh = obj.get_gradients_host(score.cpu().numpy())
            host_ms = (time.perf_counter() - t0) * 1e3
            gap = max(float(np.max(np.abs(a - b) / (2e-5 + 2e-4 * np.abs(b))))
                      for a, b in ((g, gh), (h, hh)))
            rel = max(float(np.max(np.abs(a - b))
                            / max(float(np.abs(b).max()), 1e-30))
                      for a, b in ((g, gh), (h, hh)))
            say("ranking gradients on %s: get_gradients %.3f ms on the card, "
                "get_gradients_host %.1f ms on the host; %d rows; largest "
                "gap %.3g of the largest value, %.3g of the rtol 2e-4 / "
                "atol 2e-5 bound" % (card, dev_ms, host_ms, len(g), rel, gap))
            need(gap <= 1.0, "ranking: device gradients differ from the "
                 "host oracle past rtol 2e-4 / atol 2e-5 (%.3g)" % gap)
            graph_memory(label, booster)
        del booster
        gc.collect()
        torch.cuda.empty_cache()
    need(texts["ranking"] == texts["ranking-staged"],
         "ranking: fused and staged model text differ")
    say("9b checks: fused and staged model text equal to the byte; B3 on "
        "every wave; NDCG@5 rose; gradients within the JAX package's "
        "tolerance of the host oracle")
    # ---- 11 (A4.8): the measured autotuner on the ranking bucket
    ranking_autotune(lgb, ds, params, card)
    del ds, dv
    gc.collect()

    # ---- 9d. LGBMRanker on the same data: train's model text
    t0 = time.perf_counter()
    rk, got = counted(kernels, lambda: lgb.LGBMRanker(
        n_estimators=ITERS, num_leaves=31, learning_rate=0.1).fit(
            X, y, group=q))
    add(got)
    # train's run evaluated a valid set, the estimator none: their
    # drift_fingerprint= lines' eval snapshots differ, the rest must not
    need(without_fp(rk.booster_.model_to_string())
         == without_fp(texts["ranking"]),
         "9d: LGBMRanker's model text differs from train's")
    say("9d LGBMRanker on %s: %d iterations (binning included) in %.1f s, "
        "launches %s; model text equal to train's"
        % (card, ITERS, time.perf_counter() - t0, got))
    return total


def fobj_phase(lgb, kernels, card, data, main_text):
    """9c: custom objectives on the flagship's data (phase 4's rows).  A
    fobj returning the port's BinaryLogloss gradients (on the card,
    copied to the host as numpy) with boost_from_average=false trains the
    built-in objective's trees (phase 4's, whose fused and staged text
    are equal): every Tree= section equal to the byte, on the staged
    chain.  Then a plain numpy logistic fobj with a feval (the error
    rate) for ITERS rounds: valid AUC above 0.8.  Returns the launches."""
    import torch
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.utils.config import Config
    ds, dv, _, _, _ = data
    params = flagship_params()
    dev = torch.device("cuda")
    obj = create_objective("binary", Config(params))
    obj.init(ds._handle.metadata, ds._handle.num_data, dev)
    total = {name: 0 for name in kernels}

    def builtin(preds, train_data):
        g, h = obj.get_gradients(torch.as_tensor(preds, dtype=torch.float32,
                                                 device=dev))
        return g.cpu().numpy(), h.cpu().numpy()

    y = ds.get_label()

    def logistic(preds, train_data):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - y, p * (1.0 - p)

    def error(preds, eval_data):
        return ("error", float(((preds > 0) != (eval_data.get_label() > 0))
                               .mean()), False)

    def trees(text):
        return text.split("Tree=")[1:]

    for label, fobj, feval in (("fobj-builtin", builtin, None),
                               ("fobj-logistic", logistic, error)):
        stamps = []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        evals = {}
        t0 = time.perf_counter()
        booster, got = counted(kernels, lambda: lgb.train(
            dict(params, boost_from_average=False), ds, ITERS,
            valid_sets=[dv], fobj=fobj, feval=feval, evals_result=evals,
            callbacks=[stamp], verbose_eval=False))
        t_train = time.perf_counter() - t0
        for name, n in got.items():
            total[name] += n
        need(fused_of(booster) is None, "%s: a custom objective ran fused"
             % label)
        need(got["score_update"] == ITERS, "%s: B2 launches %s"
             % (label, got))
        auc_v = evals["valid_0"]["auc"][-1]
        steady = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        say("%s on %s: %d iterations in %.3f s, steady %.4f it/s; launches "
            "%s; valid AUC %.6f%s"
            % (label, card, ITERS, t_train, steady, got, auc_v,
               "; error %s" % evals["valid_0"]["error"] if feval else ""))
        need(auc_v > 0.8, "%s: valid AUC %.4f <= 0.8" % (label, auc_v))
        if label == "fobj-builtin":
            need(trees(booster.model_to_string()) == trees(main_text),
                 "fobj-builtin: the trees differ from the built-in "
                 "objective's")
            say("fobj-builtin: every Tree= section equal to the built-in "
                "objective's (phase 4) to the byte")
        del booster
    return total


def api_phase(lgb, kernels, card, data):
    """9d: pickle and deepcopy round trips of phase 7's model (loaded from
    its text on the card) predict the same bits on 200,000 fresh rows;
    cv(nfold=5, stratified=True) on phase 7's 200,000 training rows at
    the flagship's params for ITERS rounds; LGBMClassifier at the
    flagship's params trains train's model text.  Returns the
    launches."""
    import copy
    import pickle
    X, y, Xf, _, model_text = data
    total = {name: 0 for name in kernels}
    bst = lgb.Booster(model_str=model_text)
    want = bst.predict(Xf, raw_score=True)
    t0 = time.perf_counter()
    blob = pickle.dumps(bst)
    back = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    for label, other in (("pickle", back), ("deepcopy", copy.deepcopy(bst))):
        need(other.device.type == "cuda", "9d: %s left the card" % label)
        need(np.array_equal(other.predict(Xf, raw_score=True), want),
             "9d: the %s round trip changed the predictions" % label)
    say("9d pickle and deepcopy of phase 7's model on %s: %d bytes, round "
        "trip %.3f s; the same raw scores to the bit on %d rows"
        % (card, len(blob), pickle_s, len(Xf)))
    params = flagship_params()
    t0 = time.perf_counter()
    # the Dataset takes the params: cv bins the full data before any
    # fold, with the Dataset's own params (as the JAX package's cv)
    hist, got = counted(kernels, lambda: lgb.cv(
        params, lgb.Dataset(X[:CV_ROWS], label=y[:CV_ROWS], params=params),
        num_boost_round=ITERS, nfold=5, stratified=True, seed=0))
    for name, n in got.items():
        total[name] += n
    need(len(hist["auc-mean"]) == ITERS and hist["auc-mean"][-1] > 0.8,
         "9d: cv auc-mean %s" % hist["auc-mean"])
    say("9d cv on %s: nfold 5, stratified, %d rows, %d rounds in %.1f s "
        "(binning included); auc-mean %s, auc-stdv %s; launches %s"
        % (card, CV_ROWS, ITERS, time.perf_counter() - t0,
           " ".join("%.6f" % v for v in hist["auc-mean"]),
           " ".join("%.6f" % v for v in hist["auc-stdv"]), got))
    t0 = time.perf_counter()
    clf, got = counted(kernels, lambda: lgb.LGBMClassifier(
        n_estimators=ITERS, num_leaves=params["num_leaves"],
        max_bin=params["max_bin"], learning_rate=params["learning_rate"],
        min_child_samples=params["min_data_in_leaf"],
        tpu_growth=params["tpu_growth"],
        tpu_wave_width=params["tpu_wave_width"]).fit(X, y))
    for name, n in got.items():
        total[name] += n
    ref, got = counted(kernels, lambda: lgb.train(
        params, lgb.Dataset(X, label=y), ITERS, verbose_eval=False))
    for name, n in got.items():
        total[name] += n
    need(clf.booster_.model_to_string() == ref.model_to_string(),
         "9d: LGBMClassifier's model text differs from train's")
    proba = clf.predict_proba(Xf[:1000])
    need(proba.shape == (1000, 2) and np.allclose(proba.sum(axis=1), 1.0),
         "9d: predict_proba rows")
    say("9d LGBMClassifier on %s: %d rows, %d iterations; model text equal "
        "to train's; %.1f s with train's run" % (card, len(y), ITERS,
                                                 time.perf_counter() - t0))
    return total


# ------------------------------------------------------------- phase 10
def counted_forms(kernels, fn):
    """fn() with every kernel's packed and bf16 form counts set
    to 0 just before; returns (fn's result, {"<kernel>_<form>": its
    launches during fn})."""
    for k in kernels.values():
        for form in getattr(k, "form_launches", {}):
            k.form_launches[form] = 0
    out = fn()
    return out, {"%s_%s" % (name, form): n
                 for name, k in kernels.items()
                 for form, n in getattr(k, "form_launches", {}).items()}


def wave_state(N, F, B, K, default_bin, g, leaves=None):
    """A wave state as the grower makes it, on the CPU: leaf ids over
    `leaves` leaves (K: each a parent of the wave), random weight rows,
    and a split table of K parents (the first K leaf ids) with their
    smaller children.  Returns (lid, w3, cols, psrc, cid)."""
    import torch
    lid = torch.randint(0, leaves or K, (N,), generator=g, dtype=torch.int32)
    w3 = torch.randn((N, 3), generator=g, dtype=torch.float32)
    f_w = torch.randint(0, F, (K,), generator=g)
    cols = torch.stack([
        torch.ones(K), f_w.float(),
        torch.randint(0, B - 1, (K,), generator=g).float(),
        torch.zeros(K), default_bin[f_w].float(),
        torch.randint(0, 2, (K,), generator=g).float(),
        torch.arange(K, 2 * K).float() + (leaves or K) - K, torch.zeros(K),
        torch.zeros(K), torch.full((K,), float(B))], dim=-1).contiguous()
    psrc = torch.arange(K, dtype=torch.int32)
    pick_new = torch.randint(0, 2, (K,), generator=g, dtype=torch.int32)
    cid = torch.where(pick_new > 0, cols[:, 6].to(torch.int32), psrc)
    return lid, w3, cols, psrc, cid


def with_ties(w3, g):
    """w3 with +-(1 + 2^-8), a tie of the bf16 rounding, in a tenth of
    its entries (half away from zero and half to even part there)."""
    import torch
    tie = torch.rand(w3.shape, generator=g) < 0.1
    v = torch.where(w3 < 0, -1.0, 1.0) * (1 + 2.0 ** -8)
    return torch.where(tie, v, w3)


def forms_kernel_phase(X_t, X15_t, default_bin, default_bin15, wk):
    """Phases 2 and 3 for the kernels' packed and bf16 forms.

    Packed, at F = 28, B = 16 on the max_bin = 15 flagship bins X15_t and
    their 4-bit packed copy (14 stored columns): B1 (K = W = 32), B3 (the
    root, K = 1, and K = 32) and B4 (K = 32) each against its plain
    version in float64 (phase 2's tolerance) and against the same kernel
    on the byte bins to the bit (leaf ids too), B1's routing list against
    plain, 32 warps a SM on the packed plan.  bf16, at F = 28, B = 63 on
    the flagship bins with tie weights: B1, B3 and B4 (K = 32) each equal
    to its unrounded form on the weights rounded by round_bf16 to the bit
    (the same exponents) and within tolerance of the plain bf16 version
    in float64.  Returns the records."""
    import torch

    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops.pack import pack4_host
    dev = X_t.device
    F, N = X_t.shape
    K = 32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device="cpu").manual_seed(3)
    records, notes = {}, []

    def record(name, err, call, plain, library, shape, nbytes, flops):
        records[name] = dict(max_abs_err=err, ms=time_ms(call),
                             plain_ms=time_ms(plain), library_ms=library,
                             shape=shape, nbytes=nbytes, flops=flops)

    # ---- packed
    B = 16
    lid, w3, cols, psrc, cid = (t.to(dev) for t in wave_state(
        N, F, B, K, default_bin15, g))
    Xp_t = torch.as_tensor(pack4_host(X15_t.t().cpu().numpy()).T.copy(),
                           device=dev)                      # (14, N)
    Xp = Xp_t.t().contiguous()                              # (N, 14)
    X15 = X15_t.t().contiguous()
    need(tuple(Xp_t.shape) == ((F + 1) // 2, N), "packed X_t shape")
    wmax = float(w3.abs().max())
    exps = wk.fixed_point_exponents(w3)
    lid_b, h_b = wk.wave_partition_hist(X15_t, lid, w3, cid, cols, psrc, B,
                                        exps=exps)
    lid_p, h_p = wk.wave_partition_hist(Xp_t, lid, w3, cid, cols, psrc, B,
                                        exps=exps, logical_cols=F)
    need(torch.equal(lid_p, lid_b) and torch.equal(h_p, h_b),
         "packed B1 not bit-equal to B1 on the byte bins")
    plain_lid = wk.route_rows_plain(Xp_t, lid, cols, psrc, logical_cols=F)
    need(torch.equal(lid_p, plain_lid), "packed B1 leaf ids differ from "
         "plain")
    need(all(torch.equal(a, b) for a, b in zip(
        wk.route_list(Xp_t, lid, cid, cols, psrc, logical_cols=F),
        wk.route_list_plain(Xp_t, lid, cid, cols, psrc, logical_cols=F))),
         "packed B1 routing list differs from plain")
    err, ok = hist_err(h_p, lambda a: wk.wave_histogram_plain(
        Xp_t, plain_lid, w3.double().abs() if a else w3.double(), cid, B,
        F), wmax)
    need(ok, "packed B1 histogram outside tolerance (max abs err %g)" % err)
    plan = wk.hist_plan(F, N, B, K, sms, True)
    per_sm = _build.library().lgbt_wave_hist_blocks_per_sm(
        B, plan[3], plan[4], plan[5], 0, 1)
    need(per_sm * wk._HIST_THREADS // 32 >= 32,
         "packed B1 keeps %d warps a SM resident"
         % (per_sm * wk._HIST_THREADS // 32))
    slot, n_act = slots_of(plain_lid, cid)
    byte_ms = time_ms(lambda: wk.wave_partition_hist(
        X15_t, lid, w3, cid, cols, psrc, B, exps=exps))
    Fh = (F + 1) // 2
    record("wave_partition_hist_packed", err,
           lambda: wk.wave_partition_hist(Xp_t, lid, w3, cid, cols, psrc, B,
                                          exps=exps, logical_cols=F),
           lambda: wk.wave_partition_hist_plain(Xp_t, lid, w3, cid, cols,
                                                psrc, B, logical_cols=F),
           bincount_ms(X15_t, slot, w3, B),
           "N=%d F=%d (%d packed columns) B=%d K=W=%d, %d rows in a child "
           "slot; plan %s; the byte bins' B1 at this shape %.4f ms"
           % (N, F, Fh, B, K, n_act, plan[:6], byte_ms),
           N * (4 + 4 + 1) + n_act * (Fh + 12) + K * (10 * 4 + 8)
           + K * F * B * 12, 3 * n_act * F)
    zeros = torch.zeros(N, dtype=torch.int32, device=dev)
    root = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, fn, xb, xp, ids, c in (
            ("wave_histogram_packed", wk.wave_histogram, X15_t, Xp_t, zeros,
             root),
            ("wave_histogram_packed_k32", wk.wave_histogram, X15_t, Xp_t,
             lid_b, cid),
            ("wave_histogram_rowmajor_packed", wk.wave_histogram_rowmajor,
             X15, Xp, lid_b, cid)):
        h = fn(xp, ids, w3, c, B, exps=exps, logical_cols=F)
        need(torch.equal(h, fn(xb, ids, w3, c, B, exps=exps)),
             "%s not bit-equal to the byte bins' kernel" % name)
        need(torch.equal(h, fn(xp, ids, w3, c, B, exps=exps,
                               logical_cols=F)),
             "%s repeat launch not bit-identical" % name)
        if c is cid:
            need(torch.equal(h, h_p), "%s is not packed B1's histogram"
                 % name)
        plain = (wk.wave_histogram_plain if fn is wk.wave_histogram
                 else wk.wave_histogram_rowmajor_plain)
        err, ok = hist_err(h, lambda a: plain(
            xp, ids, w3.double().abs() if a else w3.double(), c, B, F), wmax)
        need(ok, "%s outside tolerance (max abs err %g)" % (name, err))
        s_, n_act = slots_of(ids, c)
        byte_ms = time_ms(lambda: fn(xb, ids, w3, c, B, exps=exps))
        record(name, err,
               lambda: fn(xp, ids, w3, c, B, exps=exps, logical_cols=F),
               lambda: plain(xp, ids, w3, c, B, F),
               bincount_ms(X15_t, s_, w3, B),
               "N=%d F=%d (%d packed columns%s) B=%d K=%d, %d rows in a "
               "child slot; plan %s; the byte bins' kernel %.4f ms"
               % (N, F, Fh, ", row-major" if xp is Xp else "", B,
                  c.shape[0], n_act,
                  wk.hist_plan(F, N, B, c.shape[0], sms, True)[:6], byte_ms),
               N * 4 + n_act * (Fh + 12) + c.shape[0] * (4 + F * B * 12),
               3 * n_act * F)
    del Xp, X15, h, h_b, h_p
    notes.append("packed B1, B3 and B4 equal the byte bins' kernels to the "
                 "bit (leaf ids too) and their plain versions within "
                 "tolerance; B1's routing list equals plain")

    # ---- bf16, on the flagship's 63 bins, weights with ties
    B = 63
    lid, w3, cols, psrc, cid = (t.to(dev) for t in wave_state(
        N, F, B, K, default_bin, g))
    w3 = with_ties(w3.cpu(), g).to(dev)
    wr = wk.round_bf16(w3)
    need(bool((wr != w3).any()), "bf16 case: nothing rounds")
    exps = wk.fixed_point_exponents(w3)
    wmax = float(w3.abs().max())
    X = X_t.t().contiguous()
    new_lid, h1 = wk.wave_partition_hist(X_t, lid, w3, cid, cols, psrc, B,
                                         exps=exps, hilo=False)
    lid_r, h_r = wk.wave_partition_hist(X_t, lid, wr, cid, cols, psrc, B,
                                        exps=exps)
    need(torch.equal(new_lid, lid_r) and torch.equal(h1, h_r),
         "bf16 B1 is not B1 on the rounded weights")
    for name, fn, x in (
            ("wave_partition_hist_bf16", None, X_t),
            ("wave_histogram_bf16", wk.wave_histogram, X_t),
            ("wave_histogram_rowmajor_bf16", wk.wave_histogram_rowmajor, X)):
        if fn is None:
            h = h1
            call = (lambda: wk.wave_partition_hist(
                X_t, lid, w3, cid, cols, psrc, B, exps=exps, hilo=False))
            plain = (lambda: wk.wave_partition_hist_plain(
                X_t, lid, w3, cid, cols, psrc, B, hilo=False))
        else:
            h = fn(x, new_lid, w3, cid, B, exps=exps, hilo=False)
            need(torch.equal(h, h1), "%s is not bf16 B1's histogram" % name)
            need(torch.equal(h, fn(x, new_lid, wr, cid, B, exps=exps)),
                 "%s is not its unrounded form on the rounded weights"
                 % name)
            call = (lambda fn=fn, x=x: fn(x, new_lid, w3, cid, B, exps=exps,
                                          hilo=False))
            plainfn = (wk.wave_histogram_plain if fn is wk.wave_histogram
                       else wk.wave_histogram_rowmajor_plain)
            plain = (lambda plainfn=plainfn, x=x: plainfn(
                x, new_lid, w3, cid, B, hilo=False))
        err, ok = hist_err(h, lambda a: wk.wave_histogram_plain(
            X_t, new_lid, wr.double().abs() if a else wr.double(), cid, B),
            wmax)
        need(ok, "%s outside tolerance (max abs err %g)" % (name, err))
        s_, n_act = slots_of(new_lid, cid)
        record(name, err, call, plain, bincount_ms(X_t, s_, wr, B),
               "N=%d F=%d B=%d K=%d%s, %d rows in a child slot, a tenth of "
               "the weights ties" % (N, F, B, K, ", row-major"
                                    if x is X else "", n_act),
               (N * (4 + 4 + 1) + K * (10 * 4 + 8) if fn is None
                else N * 4) + n_act * (F + 12) + K * (4 + F * B * 12),
               3 * n_act * F)
    del X, h1, h_r
    notes.append("bf16 B1, B3 and B4 equal their unrounded forms on the "
                 "weights round_bf16 rounds (ties away from zero) to the "
                 "bit, and the plain bf16 versions within tolerance")

    for name, r in records.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("flops"))
        say("kernel %-30s %s: %.4f ms, plain %.4f ms, library %.4f ms, "
            "bound %.4f ms (%s), max abs err %.3g"
            % (name, r["shape"], r["ms"], r["plain_ms"], r["library_ms"],
               r["bound_ms"], r["bound_by"], r["max_abs_err"]))
    for n in notes:
        say(n)
    return records


def forms_phase(args, lgb, kernels, card, data, main_text):
    """Phase 10: the kernels' packed and bf16 forms on the flagship.

    10a. The kernel checks and times (forms_kernel_phase), the packed
    forms on the flagship's rows binned at max_bin = 15.
    10b. The flagship recipe at max_bin = 15, where tpu_bin_pack=auto
    packs the 28 columns into 14 (B1, B3 and B4 read 4-bit bins): first
    with tpu_bin_pack=false, then packed on pallas_ct, pallas_t and
    pallas, each fused then staged; every packed text must equal the
    byte bins' to the byte, and every launch of B1, B3 and B4 in a packed
    run must be a packed one.  The device bytes of X are printed.
    10c. tpu_hist_precision=bf16 on the main path (max_bin = 63),
    fused then staged (equal text), every B1 launch a bf16 one (the root,
    B3, unrounded as in the JAX package), the valid AUC within 1e-3 of
    the main path's (phase 4, unrounded) at the same iterations; then on
    pallas_t (bf16 B3 each wave) and pallas (bf16 B4), fused, whose texts
    must equal bf16 pallas_ct's.
    10d. tpu_wave_compact=true on pallas_ct, fused: the knob is taken
    and the ordinary full pass runs under it (ops/learner.py
    resolve_wave_compact), the main path's (phase 4) text to the byte.
    Returns (records, {path: launches}, {path: form launches})."""
    import torch

    from lightgbm_tpu_torch.ops import wave_kernels as wk
    ds, dv, Xt_raw, Xv, yv = data
    t_phase = time.perf_counter()
    params = flagship_params()
    p15 = dict(params, max_bin=15)
    t0 = time.perf_counter()
    ds15 = lgb.Dataset(Xt_raw, label=ds.get_label(), params=p15).construct()
    dv15 = lgb.Dataset(Xv, label=yv, reference=ds15).construct()
    td = ds15._handle
    need(td.bundle is None and td.num_features == 28
         and int(td.num_bin_arr.max()) <= 16, "unexpected max_bin=15 binning")
    say("10 data: the flagship rows binned at max_bin = 15, %d bins max "
        "(%.1f s)" % (int(td.num_bin_arr.max()), time.perf_counter() - t0))
    X_t = torch.as_tensor(np.ascontiguousarray(ds._handle.binned.T),
                          device="cuda")
    X15_t = torch.as_tensor(np.ascontiguousarray(td.binned.T),
                            device="cuda")
    records = forms_kernel_phase(X_t, X15_t, torch.as_tensor(
        ds._handle.default_bin_arr), torch.as_tensor(td.default_bin_arr),
        wk)
    del X_t, X15_t
    torch.cuda.empty_cache()
    data15 = (ds15, dv15, Xt_raw, Xv, yv)
    paths, forms = {}, {}

    def run(label, p, d, kernel, staged_text=None):
        (booster, launches, stats), got = counted_forms(
            kernels, lambda: dense_train_phase(label, p, d, lgb, kernels,
                                               card, args))
        need((fused_of(booster) is None) == (p.get("tpu_fused_iter")
                                             == "off"),
             "%s: took the other chain" % label)
        check_wave_launches(label, booster, launches, stats, kernel)
        paths[label], forms[label] = launches, got
        say("%s form launches: %s" % (label, got))
        return booster, launches, got

    # ---- 10b. packed
    booster, _, _ = run("max_bin15-bytes", dict(p15, tpu_bin_pack="false"),
                        data15, "wave_partition_hist")
    text15 = booster.model_to_string()
    learner = booster._gbdt.learner
    need(learner.packed_cols == 0, "tpu_bin_pack=false packed")
    byte_bytes = learner.X.numel() * learner.X.element_size()
    del booster, learner
    torch.cuda.empty_cache()
    for mode, kernel in (("pallas_ct", "wave_partition_hist"),
                         ("pallas_t", "wave_histogram"),
                         ("pallas", "wave_histogram_rowmajor")):
        for fused in ("auto", "off"):
            label = "packed-%s%s" % (mode, "-staged" if fused == "off"
                                     else "")
            booster, launches, got = run(
                label, dict(p15, tpu_histogram_mode=mode,
                            tpu_fused_iter=fused), data15, kernel)
            learner = booster._gbdt.learner
            need(learner.packed_cols == 28 and learner.hist_mode == mode,
                 "%s: packed_cols %d, mode %s" % (label, learner.packed_cols,
                                                  learner.hist_mode))
            for k in ("wave_partition_hist", "wave_histogram",
                      "wave_histogram_rowmajor"):
                need(got[k + "_packed"] == launches[k],
                     "%s: %d of %d %s launches packed" % (
                         label, got[k + "_packed"], launches[k], k))
            need(booster.model_to_string() == text15,
                 "%s: model text differs from the byte bins' run" % label)
            nbytes = learner.X.numel() * learner.X.element_size()
            say("%s: model text equal to the byte bins' to the byte; X on "
                "the device %d bytes %s, the byte bins' %d (%.3f)"
                % (label, nbytes, tuple(learner.X.shape), byte_bytes,
                   nbytes / byte_bytes))
            need(2 * nbytes == byte_bytes, "%s: X is not half the byte "
                 "bins' bytes" % label)
            del booster, learner
            torch.cuda.empty_cache()
    del ds15, dv15, data15
    # ---- 10c. bf16
    bf = dict(params, tpu_hist_precision="bf16")
    booster, launches, got = run("bf16", bf, data, "wave_partition_hist")
    need(booster._gbdt.learner.hist_hilo is False, "bf16: hist_hilo")
    need(got["wave_partition_hist_bf16"] == launches["wave_partition_hist"]
         and got["wave_histogram_bf16"] == 0,
         "bf16: B1 launches not all bf16, or a bf16 root %s" % got)
    bf_text = booster.model_to_string()
    need(bf_text != main_text, "bf16: the main path's text (no rounding?)")
    need(abs(AUCS["bf16"] - AUCS["wave"]) <= 1e-3,
         "bf16: valid AUC %.6f vs the main path's %.6f"
         % (AUCS["bf16"], AUCS["wave"]))
    say("bf16: valid AUC %.6f, the main path's (unrounded) %.6f, "
        "difference %.2e" % (AUCS["bf16"], AUCS["wave"],
                             AUCS["bf16"] - AUCS["wave"]))
    del booster
    torch.cuda.empty_cache()
    booster, _, got = run("bf16-staged", dict(bf, tpu_fused_iter="off"),
                          data, "wave_partition_hist")
    need(booster.model_to_string() == bf_text,
         "bf16: fused and staged model texts differ")
    del booster
    for mode, kernel in (("pallas_t", "wave_histogram"),
                         ("pallas", "wave_histogram_rowmajor")):
        label = "bf16-" + mode
        booster, launches, got = run(label, dict(bf, tpu_histogram_mode=mode),
                                     data, kernel)
        need(got[kernel + "_bf16"] == launches[kernel] - ITERS,
             "%s: %d of %d launches bf16 (all but the roots)"
             % (label, got[kernel + "_bf16"], launches[kernel]))
        need(booster.model_to_string() == bf_text,
             "%s: model text differs from bf16 pallas_ct's" % label)
        del booster
        torch.cuda.empty_cache()
    say("bf16: fused and staged text equal; pallas_t and pallas give "
        "pallas_ct's text to the byte")
    # ---- 10d. compaction: taken, and the full pass under it
    booster, _, _ = run("compact", dict(params, tpu_wave_compact=True), data,
                        "wave_partition_hist")
    need(booster._gbdt.learner.wave_compact is True,
         "compact: tpu_wave_compact not taken")
    need(booster.model_to_string() == main_text,
         "compact: model text differs from the main path's")
    del booster
    torch.cuda.empty_cache()
    say("compact: the knob taken, the main path's text to the byte")
    say("rates on %s, whole-call / steady it/s: max_bin 15 bytes %.4f / "
        "%.4f, packed pallas_ct %.4f / %.4f (staged %.4f / %.4f), packed "
        "pallas_t %.4f / %.4f, packed pallas %.4f / %.4f; bf16 %.4f / %.4f "
        "(staged %.4f / %.4f)"
        % ((card,) + RATES["max_bin15-bytes"] + RATES["packed-pallas_ct"]
           + RATES["packed-pallas_ct-staged"] + RATES["packed-pallas_t"]
           + RATES["packed-pallas"] + RATES["bf16"] + RATES["bf16-staged"]))
    say("phase 10 (packed and bf16 forms): %.1f s"
        % (time.perf_counter() - t_phase))
    return records, paths, forms



# ------------------------------------------------------------- phase 11
# ------------------------------------------------------------- phase 12
# the out-of-core bounds, fixed before the first card run (PERF.md PR 15)
# and held in fresh processes: construction's peak-RSS growth while the
# flagship's 2M x 28 float32 .npy (224 MB; its float64 rows would be 448
# MB) streams to a binned directory, and the paged upload's, which may
# hold a mapped shard, its staging (pinned, which the caching host
# allocator rounds up to a power of two) and this slack
OOC_BUILD_RSS_BOUND = 192 << 20
OOC_UPLOAD_SLACK = 8 << 20

# the resident-set watcher of the fresh processes: the growth is the
# larger of the sampled peak of VmRSS (every millisecond) above its value
# at the start and the growth of the process's high-water mark
RSS_WATCH = r"""
import resource, threading, time


def rss_now():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


def hwm():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class Watch:
    def __enter__(self):
        self.base, self.hwm0, self.stop = rss_now(), hwm(), False
        self.peak = self.base
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()
        return self

    def run(self):
        while not self.stop:
            self.peak = max(self.peak, rss_now())
            time.sleep(0.001)

    def __exit__(self, *exc):
        self.stop = True
        self.thread.join()
        self.peak = max(self.peak, rss_now())
        self.growth = max(self.peak - self.base, hwm() - self.hwm0, 0)
"""

RSS_BUILD = RSS_WATCH + r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.utils.config import Config
npy, labels, out = sys.argv[2], sys.argv[3], sys.argv[4]
params = json.loads(sys.argv[5])
y = np.load(labels)
# lazy allocations (the pool's plumbing) on a tiny build first
TrainingData.from_streamed(np.zeros((64, 4)), np.zeros(64),
                           Config(dict(params)))
with Watch() as w:
    td = TrainingData.from_streamed(npy, y, Config(dict(params)),
                                    out_dir=out)
assert td._binned is None
print(json.dumps({"growth": w.growth, "stats": td.construct_stats}))
"""

RSS_UPLOAD = RSS_WATCH + r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
from lightgbm_tpu_torch import _build
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.ops.learner import paged_device_matrix
from lightgbm_tpu_torch.utils.config import Config
big, small = sys.argv[2], sys.argv[3]
dev = torch.device("cuda")
# the CUDA context, the kernel library, the pinned allocator and the
# copies' kernels warm on a tiny directory first
_build.library()
TrainingData.from_streamed(np.random.default_rng(0).normal(size=(4096, 28)),
                           np.zeros(4096), Config({"max_bin": 63}),
                           out_dir=small, chunk_rows=1000)
tiny = TrainingData.from_binned(small)
for row_major in (False, True):
    paged_device_matrix(tiny, row_major, dev)
torch.cuda.synchronize()
td = TrainingData.from_binned(big)
reader = td._binned_reader
with Watch() as w:
    X, stats = paged_device_matrix(td, False, dev)
    torch.cuda.synchronize()
shard = max(int(s["rows"]) for s in reader.shards) * reader.num_columns
assert td._binned is None and X.shape == (reader.num_columns, td.num_data)
print(json.dumps({"growth": w.growth, "shard": shard, "stats": stats}))
"""


def fresh_process(script, *argv):
    """Runs script with argv in a fresh interpreter; its last line's
    JSON."""
    here = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, "-c", script, here]
                         + [str(a) for a in argv], capture_output=True,
                         text=True, timeout=600)
    need(run.returncode == 0, "phase 12 subprocess failed:\n%s"
         % run.stderr[-4000:])
    return json.loads(run.stdout.strip().splitlines()[-1])


def streamed_phase(args, lgb, kernels, card, data, main_text):
    """12a (after phase 4, on its rows): the training rows saved as a
    float32 .npy stream in two rounds (from_streamed, the default
    workers: the fork pool of a process that already trains on the card)
    to a binned directory; its mappers and bins must be phase 4's
    Dataset's; lightgbm_tpu_torch.train fused on the directory (the paged
    upload) must write phase 4's fused model text to the byte.  In fresh
    processes, construction's and the paged upload's peak-RSS growth
    against the bounds above.  Returns the run's launches."""
    import shutil
    import tempfile

    import torch
    from lightgbm_tpu_torch.io.dataset import TrainingData
    from lightgbm_tpu_torch.utils.config import Config
    t_phase = time.perf_counter()
    ds, _, Xt_raw, Xv, yv = data
    td = ds._handle
    params = flagship_params()
    work = tempfile.mkdtemp(prefix="chip_smoke_ooc_")
    try:
        npy, labels = os.path.join(work, "x.npy"), os.path.join(work,
                                                               "y.npy")
        out = os.path.join(work, "binned")
        t0 = time.perf_counter()
        np.save(npy, Xt_raw)
        np.save(labels, td.metadata.label.astype(np.float64))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = TrainingData.from_streamed(
            npy, td.metadata.label, Config(dict(params)),
            out_dir=out).construct_stats
        stream_s = time.perf_counter() - t0
        opened = TrainingData.from_binned(out)
        need([m.to_dict() for m in opened.bin_mappers]
             == [m.to_dict() for m in td.bin_mappers]
             and opened.used_feature_idx == td.used_feature_idx
             and opened.bundle is None,
             "12a: the streamed mappers are not phase 4's Dataset's")
        need(np.array_equal(opened.binned, td.binned),
             "12a: the streamed bins are not phase 4's Dataset's")
        del opened
        say("12a on %s: x.npy (%d x %d float32) saved in %.3f s; "
            "from_streamed to a binned directory in %.3f s: sketch %.3f s, "
            "bin %.3f s, write %.3f s, %d workers, %d chunks; mappers and "
            "bins equal phase 4's Dataset's"
            % (card, Xt_raw.shape[0], Xt_raw.shape[1], save_s, stream_s,
               st["sketch_s"], st["bin_s"], st["write_s"], st["workers"],
               st["chunks"]))

        # the valid rows binned anew on the directory's mappers (a
        # constructed Dataset keeps its reference)
        streamed = lgb.Dataset(out).construct()
        valid = streamed.create_valid(Xv, label=yv).construct()
        booster, launches, stats = dense_train_phase(
            "streamed", params, (streamed, valid, Xt_raw, Xv, yv), lgb,
            kernels, card, args)
        need(fused_of(booster) is not None, "12a: did not run fused")
        check_wave_launches("streamed", booster, launches, stats,
                            "wave_partition_hist")
        up = booster._gbdt.learner.upload_stats
        need(up["paged"] and booster._gbdt.train_data._binned is None,
             "12a: the directory did not take the paged upload")
        # a streamed directory's header carries no drift fingerprint (as
        # in the JAX package): phase 4's in-memory text has the line, the
        # directory's not, and they are otherwise equal
        got = booster.model_to_string()
        need("\ndrift_fingerprint=" in main_text
             and "drift_fingerprint=" not in got,
             "12a: the drift_fingerprint= line is not where the JAX "
             "package writes it")
        need(got == without_fp(main_text),
             "12a: the directory's model text differs from phase 4's")
        say("12a paged upload on %s: %d shards, %d bytes in %.4f s (%.3f "
            "GB/s, staging %d bytes); model text equal to phase 4's fused "
            "text to the byte but for its drift_fingerprint= line (phase "
            "4's in-memory Dataset has one, the streamed directory none); "
            "launches %s"
            % (card, up["shards"], up["bytes"], up["seconds"],
               up["bytes"] / up["seconds"] / 1e9, up["staging_bytes"],
               launches))
        del booster
        torch.cuda.empty_cache()

        build = fresh_process(RSS_BUILD, npy, labels,
                              os.path.join(work, "again"),
                              json.dumps(params))
        upload = fresh_process(RSS_UPLOAD, out, os.path.join(work, "tiny"))
        stage = upload["stats"]["staging_bytes"]
        upload_bound = (upload["shard"] + (1 << (stage - 1).bit_length())
                        + OOC_UPLOAD_SLACK)
        say("12a peak-RSS growth on %s, fresh processes: construction %d "
            "bytes (bound %d; %d workers, sketch %.3f s, bin %.3f s, write "
            "%.3f s), paged upload %d bytes (bound %d: a shard of %d, its "
            "staging of %d and %d slack; %.4f s, %.3f GB/s)"
            % (card, build["growth"], OOC_BUILD_RSS_BOUND,
               build["stats"]["workers"], build["stats"]["sketch_s"],
               build["stats"]["bin_s"], build["stats"]["write_s"],
               upload["growth"], upload_bound, upload["shard"], stage,
               OOC_UPLOAD_SLACK, upload["stats"]["seconds"],
               upload["stats"]["bytes"] / upload["stats"]["seconds"] / 1e9))
        need(build["growth"] <= OOC_BUILD_RSS_BOUND,
             "12a: construction's peak RSS grew %d bytes > %d"
             % (build["growth"], OOC_BUILD_RSS_BOUND))
        need(upload["growth"] <= upload_bound,
             "12a: the paged upload's peak RSS grew %d bytes > %d"
             % (upload["growth"], upload_bound))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("phase 12a (streamed and paged): %.1f s"
        % (time.perf_counter() - t_phase))
    return launches


def abi_phase(lgb, kernels, card, data):
    """12c (on phase 7's 200,000 x 28 training rows): the port's C ABI
    library, built by g++ from csrc/host/capi_bridge.cpp and loaded with
    ctypes.CDLL, trains on the card: DatasetCreateFromMat, BoosterCreate,
    5 x UpdateOneIter, SaveModelToString, PredictForMat; and a dataset
    streamed in by DatasetCreateByReference + DatasetPushRows (two
    chunks, the later one first) trains too.  Both model texts must equal
    lightgbm_tpu_torch.train's, the predictions within 2e-6 of
    Booster.predict.  The launches of the ABI's runs are counted."""
    import ctypes

    import torch
    from lightgbm_tpu_torch import c_api, capi_lib
    t_phase = time.perf_counter()
    X, y = data[0], data[1]
    X = np.ascontiguousarray(X, dtype=np.float64)
    y32 = np.ascontiguousarray(y, dtype=np.float32)
    n, f = X.shape
    params = flagship_params()
    t0 = time.perf_counter()
    lib = capi_lib.load()
    load_s = time.perf_counter() - t0
    pstr = " ".join("%s=%s" % kv for kv in params.items()).encode()

    def ok(rc, what):
        need(rc == 0, "12c: %s: %s" % (what, lib.LGBM_GetLastError()
                                        .decode()))

    def train_abi(ds):
        bst, fin = ctypes.c_void_p(), ctypes.c_int()
        ok(lib.LGBM_DatasetSetField(ds, b"label",
                                    y32.ctypes.data_as(ctypes.c_void_p),
                                    ctypes.c_int64(n), 0), "SetField")
        ok(lib.LGBM_BoosterCreate(ds, pstr, ctypes.byref(bst)),
           "BoosterCreate")
        need(c_api._get(bst.value).device.type == "cuda",
             "12c: the ABI's booster is not on the card")
        for _ in range(ITERS):
            ok(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)),
               "UpdateOneIter")
        torch.cuda.synchronize()
        slen = ctypes.c_int64()
        ok(lib.LGBM_BoosterSaveModelToString(
            bst, -1, ctypes.c_int64(0), ctypes.byref(slen), None),
            "SaveModelToString")
        buf = ctypes.create_string_buffer(slen.value)
        ok(lib.LGBM_BoosterSaveModelToString(
            bst, -1, slen, ctypes.byref(slen), buf), "SaveModelToString")
        return bst, buf.value.decode()

    def from_mat():
        ds = ctypes.c_void_p()
        ok(lib.LGBM_DatasetCreateFromMat(
            X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, pstr, None,
            ctypes.byref(ds)), "DatasetCreateFromMat")
        return ds, train_abi(ds)

    t0 = time.perf_counter()
    (ds, (bst, text)), launches = counted(kernels, from_mat)
    abi_s = time.perf_counter() - t0
    want = lgb.train(params, lgb.Dataset(X, label=y), ITERS,
                     verbose_eval=False)
    need(text == want.model_to_string(),
         "12c: the C ABI's model text differs from lightgbm_tpu_torch."
         "train's")
    out_len = ctypes.c_int64()
    preds = np.zeros(n, np.float64)
    t0 = time.perf_counter()
    ok(lib.LGBM_BoosterPredictForMat(
        bst, X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, 0, -1, b"",
        ctypes.byref(out_len),
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_double))),
        "PredictForMat")
    pred_s = time.perf_counter() - t0
    err = float(np.abs(preds - want.predict(X)).max())
    need(out_len.value == n and err <= 2e-6,
         "12c: PredictForMat differs from Booster.predict by %g" % err)

    def pushed():
        ds2 = ctypes.c_void_p()
        ok(lib.LGBM_DatasetCreateByReference(ds, ctypes.c_int64(n),
                                             ctypes.byref(ds2)),
           "DatasetCreateByReference")
        half = n // 2
        for lo, hi in ((half, n), (0, half)):
            part = np.ascontiguousarray(X[lo:hi])
            ok(lib.LGBM_DatasetPushRows(
                ds2, part.ctypes.data_as(ctypes.c_void_p), 1, hi - lo, f,
                lo), "DatasetPushRows")
        return ds2, train_abi(ds2)

    (ds2, (bst2, text2)), launches2 = counted(kernels, pushed)
    # a dataset of pushed rows is binned on its reference's mappers and
    # carries no drift fingerprint, as in the JAX package: the line is
    # the one difference
    need("\ndrift_fingerprint=" in text
         and "drift_fingerprint=" not in text2,
         "12c: the drift_fingerprint= line is not where the JAX package "
         "writes it")
    need(text2 == without_fp(text),
         "12c: the pushed rows' model text differs")
    for h in (bst, bst2):
        ok(lib.LGBM_BoosterFree(h), "BoosterFree")
    for h in (ds, ds2):
        ok(lib.LGBM_DatasetFree(h), "DatasetFree")
    total = {k: launches[k] + launches2[k] for k in launches}
    need(total["wave_partition_hist"] > 0 and total["wave_histogram"] > 0
         and total["score_update"] == 2 * ITERS,
         "12c: a kernel of the path did not launch: %s" % total)
    say("12c on %s: the C ABI library (%s, built in %.1f s, loaded in "
        "%.1f s) trained %d x %d rows on the card: create + %d iterations "
        "%.3f s, PredictForMat %.3f s (max |diff| %.3g against "
        "Booster.predict); model text equal to train's, and again from "
        "DatasetPushRows; launches %s"
        % (card, capi_lib.lib_path().name, capi_lib.build_seconds, load_s,
           n, f, ITERS, abi_s, pred_s, err, total))
    say("phase 12c (the C ABI): %.1f s" % (time.perf_counter() - t_phase))
    return total


def describe_cell(c):
    """A cell dict as obs explain names it."""
    return "%s W=%s %s%s%s" % (
        c["hist_mode"], c["wave_width"],
        "hilo" if c["hist_hilo"] else "bf16",
        " compact" if c["compact"] else "",
        " fused" if c["fused"] else " staged")


def autotune_lines(label, learner, card):
    """Print a learner's autotune decision: each probed cell's seconds a
    probe tree and roofline position, the winner, margin, probe seconds
    and the probes' launches; require every enumerated cell measured.
    Returns the decision event's fields."""
    from lightgbm_tpu_torch.obs.roofline import describe_roofline_position
    from lightgbm_tpu_torch.ops import autotune as at
    dec = learner.autotune
    fields = next(f for ev, f in dec.events if ev == "autotune_decision")
    for c in fields["cells"]:
        r = c["roofline"]
        say("%s probe on %s: %-30s %.6f s a probe tree (the mean of %d "
            "timed trees); at %s (HBM %.4f, f32 %.4f of the %s row, "
            "%s)" % (label, card, describe_cell(c["cell"]), c["s_per_wave"],
                     int(learner.config.tpu_autotune_waves),
                     describe_roofline_position(r), r["hbm_util"],
                     r["flop_util"], r["device_kind"], r["roof_source"]))
    say("%s autotune on %s: %s/%s, bucket %s on %s; winner %s (prior %s); "
        "margin %.4f; overhead_s %.4f; probe launches %s"
        % (label, card, dec.mode, dec.source, dec.bucket,
           fields["device_kind"], describe_cell(fields["cell"]),
           describe_cell(fields["prior"]), dec.margin, dec.overhead_s,
           learner.autotune_launches))
    want = at.enumerate_cells(at.Cell.from_dict(fields["prior"]),
                              learner.autotune_shape, learner.autotune_pins)
    need(dec.source == "measured"
         and [c for c, _ in dec.probes] == want,
         "%s: the probes %s are not every enumerated cell %s"
         % (label, [c for c, _ in dec.probes], want))
    return fields


def pinned_params(params, cell):
    """params with every tuned dimension pinned at cell."""
    return dict(params, tpu_histogram_mode=cell["hist_mode"],
                tpu_wave_width=cell["wave_width"],
                tpu_hist_precision="hilo" if cell["hist_hilo"] else "bf16",
                tpu_wave_compact=cell["compact"],
                tpu_fused_iter="on" if cell["fused"] else "off",
                tpu_autotune="off")


def autotune_phase(args, lgb, kernels, card, data):
    """Phase 11 on phase 4's Dataset.  Returns the probes' launches."""
    import contextlib
    import gc
    import io
    import tempfile
    import torch
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.obs import timers
    from lightgbm_tpu_torch.obs.events import read_events, validate_event
    from lightgbm_tpu_torch.obs.roofline import device_kind
    from lightgbm_tpu_torch.ops import autotune as at
    t_phase = time.perf_counter()
    ds, dv = data[0], data[1]
    work = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    cache = os.path.join(work, "autotune_cache.json")
    base = dict(flagship_params(), tpu_autotune_cache=cache,
                obs_timing="iter")

    def train(label, params, iters=ITERS):
        f0 = timers.fence_count()
        t0 = time.perf_counter()
        booster, got = counted(kernels, lambda: lgb.train(
            params, ds, iters, valid_sets=[dv], verbose_eval=False))
        torch.cuda.synchronize()
        say("%s on %s: %d iterations in %.3f s including set-up; launches "
            "%s; %d fences" % (label, card, iters,
                               time.perf_counter() - t0, got,
                               timers.fence_count() - f0))
        return booster, got, timers.fence_count() - f0

    # ---- 11a. measure: a fresh cache, the timeline under iter
    ev_measure = os.path.join(work, "measure.jsonl")
    booster, got, fences = train("11a measure", dict(
        base, tpu_autotune="measure", obs_events_path=ev_measure))
    lrn = booster._gbdt.learner
    fields = autotune_lines("11a flagship", lrn, card)
    probes = lrn.autotune.probes
    waves = int(lrn.config.tpu_autotune_waves)
    need(fences == len(probes) * (1 + waves) + ITERS,
         "11a: %d fences, wanted %d probe runs + %d iterations"
         % (fences, len(probes) * (1 + waves), ITERS))
    probe_launches = dict(lrn.autotune_launches)
    need(probe_launches.get("wave_histogram", 0) > 0
         and probe_launches.get("score_update", 0) > 0,
         "11a: the probes launched no B3/B2 (%s)" % probe_launches)
    kind = device_kind(torch.device("cuda"))
    key = "%s|v2|c28_b64_l255_n%d" % (kind, at.row_bucket(args.rows))
    with open(cache) as f:
        blob = json.load(f)
    need(list(blob["entries"]) == [key],
         "11a: cache keys %s, wanted [%s]" % (list(blob["entries"]), key))
    measured_text = booster.model_to_string()
    events = read_events(ev_measure)
    for e in events:
        validate_event(e, strict=True)
    need(sum(e["ev"] == "autotune_probe" for e in events) == len(probes)
         and sum(e["ev"] == "iter" for e in events) == ITERS,
         "11a: the timeline lacks probe or iter events")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["obs", "explain", ev_measure])
    text = out.getvalue()
    need(rc == 0 and all(describe_cell(c.as_dict()) in text
                         for c, _ in probes),
         "11a: obs explain (rc %d) does not name every probe" % rc)
    say("11a checks: %d cells measured, every event valid (%d), the cache "
        "holds %s, obs explain names every probe" % (len(probes),
                                                      len(events), key))
    del booster, lrn
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11b. prior: the cached winner, no probe
    ev_prior = os.path.join(work, "prior.jsonl")
    booster, got, fences = train("11b prior", dict(
        base, tpu_autotune="prior", obs_events_path=ev_prior))
    lrn = booster._gbdt.learner
    names = [e["ev"] for e in read_events(ev_prior)]
    need(lrn.autotune_source == "cache" and lrn.autotune.cache_hit
         and "autotune_probe" not in names and not lrn.autotune_launches,
         "11b: prior mode did not take the cache without probing")
    need(fences == ITERS, "11b: %d fences under obs_timing=iter, wanted "
         "one an iteration (%d)" % (fences, ITERS))
    need(booster.model_to_string() == measured_text,
         "11b: the cached winner's text differs from the measured run's")
    del booster, lrn
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11c. the winner pinned, NULL observer: the fence audit's zero
    pinned = pinned_params(flagship_params(), fields["cell"])
    booster, got, fences = train("11c pinned winner", pinned)
    need(fences == 0, "11c: %d fences over a NULL-observer run" % fences)
    need(booster.model_to_string() == measured_text,
         "11c: the measured run's text differs from the pinned winner's")
    del booster
    gc.collect()
    torch.cuda.empty_cache()
    say("11b/c checks: the prior run took the cache with no probe; the "
        "measured, cached and pinned runs' texts equal to the byte; fences "
        "0 over the NULL observer, one an iteration under iter")

    # ---- 11d. a trace window over iteration 2, staged (the kernels
    # launched one by one), Chrome trace in obs_trace_dir
    trace_dir = os.path.join(work, "trace")
    booster, got, fences = train("11d trace window", dict(
        flagship_params(), tpu_fused_iter="off", obs_trace_iters="2:3",
        obs_trace_dir=trace_dir, obs_events_path=os.path.join(
            work, "trace.jsonl")), iters=3)
    paths = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
    need(len(paths) == 1, "11d: %d trace files" % len(paths))
    with open(paths[0]) as f:
        trace = json.load(f)["traceEvents"]
    names = {str(e.get("name", "")) for e in trace}
    found = {k: sum(k in n for n in names) for k in
             ("list_kernel", "hist_kernel", "finish_kernel",
              "score_update_kernel")}
    say("11d trace on %s: %s, %d events, %.1f MB; kernel names found %s"
        % (card, os.path.basename(paths[0]), len(trace),
           os.path.getsize(paths[0]) / 1e6, found))
    need(all(found.values()), "11d: the trace does not name the port's "
         "kernels (%s)" % found)
    del booster
    gc.collect()
    torch.cuda.empty_cache()
    say("phase 11 (the autotuner and the observer): %.1f s"
        % (time.perf_counter() - t_phase))
    return probe_launches


def ranking_autotune(lgb, ds, params, card):
    """11 (A4.8): measure on 9b's ranking Dataset (136 x 256 bins, past
    the ct bound), a fresh cache; the winner printed."""
    import tempfile
    t0 = time.perf_counter()
    cache = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_rank_"),
                         "autotune_cache.json")
    booster = lgb.Booster(dict(params, tpu_autotune="measure",
                               tpu_autotune_cache=cache), ds)
    fields = autotune_lines("11 ranking (A4.8)", booster._gbdt.learner,
                            card)
    say("11 ranking winner on %s: %s; probing %.1f s"
        % (card, describe_cell(fields["cell"]), time.perf_counter() - t0))
    del booster


# ------------------------------------------------------------- phase 13
def bins_t_of(ds):
    """A Dataset's bin matrix transposed (F, N) on the card, in its dtype
    (uint16 past 256 bins)."""
    import torch
    return torch.as_tensor(np.ascontiguousarray(ds._handle.binned.T),
                           device="cuda")


def f64_err(got, plain):
    """(max_abs_err, ok) of an f64-form histogram against its plain
    version in float64: a cell may differ by 1e-12 x (sum of |w| over
    the cell) + 1e-14 x max|w|, the plain version's own row-order
    rounding being the larger part (the kernels sum in 128-bit fixed
    point, csrc/fixed_point.cuh, and round once)."""
    want = plain(False)
    diff = (got - want).abs()
    tol = 1e-12 * plain(True) + 1e-14 * float(plain.wmax)
    return float(diff.max()), bool((diff <= tol).all())


# B5's leaf sizes (wide_hist_ab.py --b5): no row, ~N/4096, ~N/64, the root
B5_SIZES = ("none", "n/4096", "n/64", "root")


def check_b5_sizes(lh, wk, X, w3, exps, B, tag, g):
    """B5 on X's rows and the weight rows w3 at B5_SIZES (leaf ids over 64
    leaves, leaf 2 holding ~N/4096 rows and leaf 1 ~N/64; every row in
    leaf 0), given a grower's workspace: bit-equal to B4 at K = 1, within
    the tolerance of its plain version in float64 (f64_err's for float64
    weights, else hist_err's), the workspace's sums zero
    after each call, and for f32 weights the deferred form's sums,
    converted by the finish alone, the finished histogram.  Returns a
    note."""
    import torch
    dev = X.device
    N, F = X.shape
    lid = torch.randint(3, 64, (N,), generator=g, dtype=torch.int32)
    lid[torch.randperm(N, generator=g)[:N // 64]] = 1
    lid[torch.randperm(N, generator=g)[:N // 4096]] = 2
    lid = lid.to(dev)
    roots = torch.zeros_like(lid)
    wide = w3.dtype == torch.float64
    work = wk.list_workspace(N, 1, F, B, dev, wide, rowmajor=True)
    words = wk.leaf_sum_words(F, B, wide)
    w64 = w3.double()
    wmax = max(float(w3.abs().max()), 1.0)
    plan = lh.leaf_plan(F, B, wide)
    errs = []
    for size, ids, leaf in zip(B5_SIZES, (lid, lid, lid, roots),
                               (-1, 2, 1, 0)):
        leaf_t = torch.full((1,), leaf, dtype=torch.int32, device=dev)
        h = lh.leaf_histogram(X, None, None, ids, leaf_t, None, B, w3=w3,
                              exps=exps, work=work)
        need(torch.equal(h, wk.wave_histogram_rowmajor(
            X, ids, w3, leaf_t, B, exps=exps)[0]),
            "%s: B5 at leaf size %s is not B4 at K = 1 to the bit"
            % (tag, size))
        need(not bool(work[work.numel() - words:].any()),
             "%s: B5 at leaf size %s left its sums non-zero" % (tag, size))

        def plain(absolute, ids=ids, leaf_t=leaf_t):
            return wk.wave_histogram_rowmajor_plain(
                X, ids, w64.abs() if absolute else w64, leaf_t, B)[0]
        plain.wmax = wmax
        err, ok = f64_err(h, plain) if wide else hist_err(h, plain, wmax)
        need(ok, "%s: B5 at leaf size %s outside tolerance (max abs err %g)"
             % (tag, size, err))
        errs.append(err)
        if not wide:
            sums = lh.leaf_histogram(X, None, None, ids, leaf_t, None, B,
                                     w3=w3, exps=exps, work=work,
                                     finish=False)
            need(torch.equal(wk.finish_hist(sums, leaf_t, exps)
                             .reshape(h.shape), h),
                 "%s: B5's deferred sums at leaf size %s do not finish to "
                 "its histogram" % (tag, size))
    return ("%s: B5 (plan %s) at leaf sizes %s bit-equal to B4 at K = 1, "
            "max abs err %s against plain, sums zero after each call%s"
            % (tag, tuple(plan), "/".join(B5_SIZES),
               "/".join("%.3g" % e for e in errs),
               "" if wide else ", deferred sums finish to it"))


def wide_kernel_phase(X_t, default_bin, X63_t, default_bin63, X4_t,
                      byte255, wk, lh):
    """Phases 2 and 3 for the kernels' uint16 and f64 forms, the wide
    byte rows, and the bin tiles.

    uint16, at F = 28, B = 1023 on the flagship rows binned at max_bin
    1023 (X_t (28, N) uint16), K = W = 32: B1 (ids exactly the plain
    routing), B3 on B1's ids (K = 32) and at the root (K = 1), B4 (K =
    32) and B5 (the leaf of slot 0), each within phase 2's tolerance of
    its plain version in float64, two launches bit-identical, and with
    B1's exponents B3 = B1, B4 = B3 and B5 = B4's slot, and B1, B3 and
    B3's root equal to the scatter engine's histogram
    (ops/histogram.py scatter_histogram, an int64 index_add_ of the same
    fixed point), to the bit.  Byte bins at B = 255 (the flagship rows
    binned at max_bin 255: byte255 = (X_t, default bins, B)): the same
    checks and times.  Both
    take the slot-ordered pass at K = 32 (wave_kernels.hist_plan
    ordered); each record's shape names its plan and the reads a listed
    row costs (plan_reads).  f64 (float64 weights, tpu_use_dp), at B =
    63 on the flagship bins: the same checks, within f64_err's bound of
    the float64 plain version.
    Bin tiles: B3 (K = 1) and B4 (K = 4) on 4 flagship columns binned at
    max_bin 16383 (X4_t), whose (slot, feature) row of 64-bit cells
    exceeds the shared-memory budget, so the plan tiles the bin axis;
    both within tolerance of plain and bit-equal to each other's slots.
    Returns the records."""
    import torch

    from lightgbm_tpu_torch.ops.histogram import scatter_histogram
    dev = X_t.device
    F, N = X_t.shape
    K = 32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device="cpu").manual_seed(13)
    records, notes = {}, []

    def record(name, err, call, plain, library, shape, nbytes, flops):
        records[name] = dict(max_abs_err=err, ms=time_ms(call),
                             plain_ms=time_ms(plain), library_ms=library,
                             shape=shape, nbytes=nbytes, flops=flops)

    def forms(X_t, default_bin, B, wide, tag):
        lid, w3, cols, psrc, cid = (t.to(dev) for t in wave_state(
            N, F, B, K, default_bin, g))
        if wide:
            w3 = w3.double()
        wmax = float(w3.abs().max())
        exps = wk.fixed_point_exponents(w3)
        X = X_t.t().contiguous()
        bb = X_t.element_size()
        wb = 24 if wide else 12                  # a weight row, a bin's sums
        new_lid, h1 = wk.wave_partition_hist(X_t, lid, w3, cid, cols, psrc,
                                             B, exps=exps)
        lid2, h1b = wk.wave_partition_hist(X_t, lid, w3, cid, cols, psrc, B,
                                           exps=exps)
        need(torch.equal(new_lid, wk.route_rows_plain(X_t, lid, cols, psrc))
             and torch.equal(new_lid, lid2),
             "%s B1 leaf ids differ from plain" % tag)
        need(torch.equal(h1, h1b), "%s B1 repeat not bit-identical" % tag)
        need(h1.dtype == (torch.float64 if wide else torch.float32),
             "%s B1 histogram dtype %s" % (tag, h1.dtype))
        root = torch.zeros(1, dtype=torch.int32, device=dev)
        zeros = torch.zeros(N, dtype=torch.int32, device=dev)
        leaf = cid[:1]
        h3 = wk.wave_histogram(X_t, new_lid, w3, cid, B, exps=exps)
        h3r = wk.wave_histogram(X_t, zeros, w3, root, B, exps=exps)
        h4 = wk.wave_histogram_rowmajor(X, new_lid, w3, cid, B, exps=exps)
        h5 = lh.leaf_histogram(X, None, None, new_lid, leaf, None, B,
                               w3=w3, exps=exps)
        need(torch.equal(h3, h1) and torch.equal(h4, h3)
             and torch.equal(h5, h4[0]),
             "%s: B3, B4, B5 not B1's histogram to the bit" % tag)
        notes.append(check_b5_sizes(lh, wk, X, w3, exps, B, tag, g))
        need(torch.equal(h1, scatter_histogram(X, new_lid, w3, cid, B, exps))
             and torch.equal(h3r, scatter_histogram(X, zeros, w3, root, B,
                                                    exps)),
             "%s: B1, B3 not the scatter engine's histogram to the bit"
             % tag)
        for name, h, x, ids, c in (
                ("wave_partition_hist", h1, X_t, new_lid, cid),
                ("wave_histogram", h3r, X_t, zeros, root),
                ("wave_histogram_k32", h3, X_t, new_lid, cid),
                ("wave_histogram_rowmajor", h4, X_t, new_lid, cid),
                ("leaf_histogram", h5[None], X_t, new_lid, leaf)):
            def plain(absolute, ids=ids, c=c):
                w = w3.double()
                return wk.wave_histogram_plain(
                    X_t, ids, w.abs() if absolute else w, c, B)
            plain.wmax = wmax
            err, ok = (f64_err(h, plain) if wide else
                       hist_err(h, plain, wmax))
            need(ok, "%s %s outside tolerance (max abs err %g)"
                 % (tag, name, err))
            s_, n_act = slots_of(ids, c)
            kc = c.shape[0]
            xi = wk.bins_i32(wk.indexable(X_t))
            lib = bincount_ms(xi, s_, w3, B)
            if name == "wave_partition_hist":
                call = (lambda: wk.wave_partition_hist(
                    X_t, lid, w3, cid, cols, psrc, B, exps=exps))
                pl = (lambda: wk.wave_partition_hist_plain(
                    X_t, lid, w3, cid, cols, psrc, B))
                nbytes = N * (4 + 4 + bb) + K * (10 * 4 + 8)
            elif name == "leaf_histogram":
                call = (lambda: lh.leaf_histogram(
                    X, None, None, new_lid, leaf, None, B, w3=w3,
                    exps=exps))
                pl = (lambda: wk.wave_histogram_rowmajor_plain(
                    X, new_lid, w3, leaf, B))
                nbytes = N * 4 + 4
            else:
                b3 = name.startswith("wave_histogram") and "row" not in name
                fn = wk.wave_histogram if b3 else wk.wave_histogram_rowmajor
                xx = X_t if b3 else X
                plainfn = (wk.wave_histogram_plain if b3
                           else wk.wave_histogram_rowmajor_plain)
                call = (lambda fn=fn, xx=xx, ids=ids, c=c: fn(
                    xx, ids, w3, c, B, exps=exps))
                pl = (lambda plainfn=plainfn, xx=xx, ids=ids, c=c: plainfn(
                    xx, ids, w3, c, B))
                nbytes = N * 4 + kc * 4
            del xi
            plan = wk.hist_plan(F, N, B, kc, sms, False, wide)
            how = ("plan %s (%s), bin tiles %d, %d reads a listed row"
                   % (tuple(plan[:6]),
                      "slot-ordered" if plan.ordered else "slot-sliced",
                      len(wk.bin_tiles(F, B, plan[1], plan[4])),
                      wk.plan_reads(plan, kc)))
            if name == "leaf_histogram" and lh.leaf_plan(F, B, wide).fused:
                how = "one-scan plan %s" % (tuple(lh.leaf_plan(F, B, wide)),)
            record("%s_%s" % (name, tag), err, call, pl, lib,
                   "N=%d F=%d B=%d K=%d (%s bins, %s weights)%s, %d rows in "
                   "a child slot; %s"
                   % (N, F, B, kc, X_t.dtype, w3.dtype,
                      ", row-major" if name in ("wave_histogram_rowmajor",
                                                "leaf_histogram") else "",
                      n_act, how),
                   nbytes + n_act * (F * bb + wb) + kc * F * B * wb,
                   3 * n_act * F)
        del X
        notes.append("%s forms: B1's ids the plain routing's; B1, B3, B4 "
                     "and B5 within tolerance of plain, repeats "
                     "bit-identical, and with B1's exponents B3 = B1, B4 = "
                     "B3, B5 = B4's slot and B1 and B3 (K = 32 and the "
                     "root) the scatter engine's to the bit" % tag)

    forms(X_t, default_bin, 1023, False, "uint16")
    forms(byte255[0], byte255[1], byte255[2], False, "byte255")
    forms(X63_t, default_bin63, 63, True, "f64")

    # ---- bin tiles: B past what one (slot, feature) row of shared
    # memory holds
    F4, N4 = X4_t.shape
    B4 = int(wk.bins_i32(wk.indexable(X4_t)).max()) + 1
    lid, w3, cols, psrc, cid = (t.to(dev) for t in wave_state(
        N4, F4, B4, 4, torch.zeros(F4, dtype=torch.long), g))
    exps = wk.fixed_point_exponents(w3)
    X4 = X4_t.t().contiguous()
    root = torch.zeros(1, dtype=torch.int32, device=dev)
    zeros = torch.zeros(N4, dtype=torch.int32, device=dev)
    wmax = float(w3.abs().max())
    lines = []
    for label, fn, x, ids, c in (
            ("B3 root", wk.wave_histogram, X4_t, zeros, root),
            ("B4 K=4", wk.wave_histogram_rowmajor, X4, lid, cid)):
        plan = wk.hist_plan(F4, N4, B4, c.shape[0], sms)
        tiles = wk.bin_tiles(F4, B4, plan[1], plan[4])
        need(len(tiles) > 1, "bin tiles: B = %d took one tile" % B4)
        h = fn(x, ids, w3, c, B4, exps=exps)
        need(torch.equal(h, fn(x, ids, w3, c, B4, exps=exps)),
             "bin tiles: %s repeat not bit-identical" % label)
        err, ok = hist_err(h, wave_plain64(wk.wave_histogram_plain, X4_t,
                                           ids, w3, c, B4), wmax)
        need(ok, "bin tiles: %s outside tolerance (max abs err %g)"
             % (label, err))
        need(bool((h[..., tiles[-1][0]:, 2] != 0).any()),
             "bin tiles: %s's last tile holds no row" % label)
        ms = time_ms(lambda: fn(x, ids, w3, c, B4, exps=exps))
        lines.append("%s %.4f ms (plan %s, %d tiles of %d bins, %d bytes "
                     "of shared memory a block, max abs err %.3g)"
                     % (label, ms, plan[:6], len(tiles),
                        tiles[0][1] - tiles[0][0], plan[6], err))
    del X4
    notes.append("bin tiles at F = %d, B = %d, N = %d: %s; both within "
                 "tolerance of plain, repeats bit-identical"
                 % (F4, B4, N4, "; ".join(lines)))

    for name, r in records.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("flops"))
        say("kernel %-32s %s: %.4f ms, plain %.4f ms, library %.4f ms, "
            "bound %.4f ms (%s), max abs err %.3g"
            % (name, r["shape"], r["ms"], r["plain_ms"], r["library_ms"],
               r["bound_ms"], r["bound_by"], r["max_abs_err"]))
    for n in notes:
        say(n)
    return records


def split_search_memory():
    """The split search's device memory at wide bins: best_splits_batched
    on random (K, F, B, 3) histograms at a wave's 2W = 64 children of
    F = 28 features at B = 1024 bins (f32 and f64) and at the bin-tile
    check's shape (2 children, F = 4, B = 16384); prints each call's peak
    allocation above what was held before it, against the histograms'
    own bytes."""
    import torch

    from lightgbm_tpu_torch.ops.split_finder import (FeatureMeta,
                                                     SplitParams,
                                                     best_splits_batched)
    params = SplitParams(0.0, 0.0, 0.0, 1.0, 1e-3, True)
    out = []
    for K, F, B, dt in ((64, 28, 1024, torch.float32),
                        (64, 28, 1024, torch.float64),
                        (2, 4, 16384, torch.float32)):
        g = torch.Generator(device="cuda").manual_seed(K + B)
        h = torch.rand((K, F, B, 3), generator=g, device="cuda", dtype=dt)
        h[..., 0] -= 0.5
        sums = h.sum(dim=(1, 2)) / F
        meta = FeatureMeta(
            num_bin=torch.full((F,), B, dtype=torch.int32, device="cuda"),
            default_bin=torch.zeros(F, dtype=torch.int32, device="cuda"),
            is_categorical=torch.zeros(F, dtype=torch.bool, device="cuda"))
        mask = torch.ones(F, dtype=torch.bool, device="cuda")
        depth = torch.zeros(K, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        best_splits_batched(h, sums, depth, meta, mask, params, 0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out.append("K=%d F=%d B=%d %s: %d bytes above the %d of the "
                   "histograms (%.1fx)" % (K, F, B, str(dt)[6:], peak,
                                           h.numel() * h.element_size(),
                                           peak / (h.numel()
                                                   * h.element_size())))
        del h, sums
    say("13 split search memory: %s" % "; ".join(out))


# rows of phase 13's exact-growth runs on the XLA engines (each split is
# a pass over every row)
ENGINE_EXACT_ROWS = 200_000
HIST_KERNELS = ("wave_partition_hist", "wave_histogram",
                "wave_histogram_rowmajor", "leaf_histogram",
                "sparse_wave_histogram")


def wide_phase(args, lgb, kernels, card, data, main_text):
    """Phase 13: two-byte bins, the f64 form and the XLA engines.

    13a-c. The kernel checks and times (wide_kernel_phase).
    13d. The flagship recipe at max_bin 1023 on the first CUT_ROWS of the
    flagship rows (uint16 bins; 28 x 1024 past
    the ct bound): auto (pallas_t, B3 every wave), pallas_ct (B1),
    pallas (B4) and exact growth (B5), each fused then staged with equal
    text, every launch of those kernels their uint16 form, valid AUC
    above 0.8; the three wave dataflows' texts equal to the byte.
    13g. The flagship recipe at max_bin 255 on the same rows (byte bins,
    B1's and B3's slot-ordered pass): auto (pallas_t, B3) and pallas_ct
    (B1), fused, their texts equal to the byte.
    13e. tpu_use_dp at max_bin 63: pallas_ct fused then staged (equal
    text), pallas and exact fused; every histogram launch the f64 form,
    the score update the gather (B2 never); pallas's text pallas_ct's.
    13f. The XLA engines on the main path's Dataset: onehot and scatter
    under wave growth (fused, then staged: equal text) and exact growth
    (fused; on its first ENGINE_EXACT_ROWS rows, as each split is a
    full-N masked pass), no histogram kernel launched; scatter sums the
    fixed point of the kernels, so its wave text must be the main path's
    (phase 4) and its exact text B5's exact growth's on the same rows to
    the byte; then
    tpu_score_update=gather on the main path (B2 never; the main text,
    the gather being B2's arithmetic).
    Returns (records, {path: launches}, {path: form launches})."""
    import torch

    from lightgbm_tpu_torch.ops import leaf_hist as lh
    from lightgbm_tpu_torch.ops import wave_kernels as wk
    ds, _, Xt_raw, Xv, yv = data
    t_phase = time.perf_counter()
    params = flagship_params()
    p1023 = dict(params, max_bin=1023)
    t0 = time.perf_counter()
    Xw = Xt_raw[:CUT_ROWS]
    ds_w = lgb.Dataset(Xw, label=ds.get_label()[:CUT_ROWS],
                       params=p1023).construct()
    dv_w = lgb.Dataset(Xv, label=yv, reference=ds_w).construct()
    td = ds_w._handle
    need(td.bundle is None and td.binned.dtype == np.uint16
         and int(td.num_bin_arr.max()) > 256, "unexpected max_bin=1023 "
         "binning")
    say("13 data: the flagship rows binned at max_bin = 1023, %d bins max, "
        "%s (%.1f s)" % (int(td.num_bin_arr.max()), td.binned.dtype,
                         time.perf_counter() - t0))
    t0 = time.perf_counter()
    p4 = dict(params, max_bin=16383)
    ds4 = lgb.Dataset(Xw[:, :4], params=p4).construct()
    say("13 data: 4 flagship columns binned at max_bin = 16383, %d bins max "
        "(%.1f s)" % (int(ds4._handle.num_bin_arr.max()),
                      time.perf_counter() - t0))
    t0 = time.perf_counter()
    p255 = dict(params, max_bin=255)
    ds255 = lgb.Dataset(Xw, label=ds.get_label()[:CUT_ROWS],
                        params=p255).construct()
    t255 = ds255._handle
    B255 = int(t255.num_bin_arr.max())
    need(t255.bundle is None and t255.binned.dtype == np.uint8
         and 63 < B255 <= 256, "unexpected max_bin=255 binning")
    say("13 data: the flagship rows binned at max_bin = 255, %d bins max, "
        "%s (%.1f s)" % (B255, t255.binned.dtype, time.perf_counter() - t0))
    # the kernel checks at the cut's rows: the max_bin 63 bins' first ones
    X_t, X4_t = bins_t_of(ds_w), bins_t_of(ds4)
    X63_t = bins_t_of(ds)[:, :X_t.shape[1]].contiguous()
    records = wide_kernel_phase(
        X_t, torch.as_tensor(td.default_bin_arr), X63_t,
        torch.as_tensor(ds._handle.default_bin_arr), X4_t,
        (bins_t_of(ds255), torch.as_tensor(t255.default_bin_arr), B255),
        wk, lh)
    del X_t, X63_t, X4_t, ds4
    torch.cuda.empty_cache()
    split_search_memory()
    torch.cuda.empty_cache()
    data_w = (ds_w, dv_w, Xw, Xv, yv)
    paths, forms = {}, {}

    def run(label, p, d, kernel, updates=ITERS):
        (booster, launches, stats), got = counted_forms(
            kernels, lambda: dense_train_phase(label, p, d, lgb, kernels,
                                               card, args, updates=updates))
        need((fused_of(booster) is None) == (p.get("tpu_fused_iter")
                                             == "off"),
             "%s: took the other chain" % label)
        if kernel == "leaf_histogram":
            check_exact_launches(label, booster, launches, stats, updates)
        elif kernel is not None:
            check_wave_launches(label, booster, launches, stats, kernel,
                                updates)
        else:
            need(all(launches[k] == 0 for k in HIST_KERNELS),
                 "%s: a histogram kernel launched under an XLA engine: %s"
                 % (label, launches))
        paths[label], forms[label] = launches, got
        say("%s form launches: %s" % (label, {k: v for k, v in got.items()
                                              if v}))
        return booster, launches, got

    def twin(label, p, d, kernel, text, updates=ITERS):
        booster, _, _ = run(label + "-staged", dict(p, tpu_fused_iter="off"),
                            d, kernel, updates)
        need(booster.model_to_string() == text,
             "%s: fused and staged model texts differ" % label)
        del booster
        torch.cuda.empty_cache()

    # ---- 13d. max_bin 1023: uint16 bins through B3, B1, B4 and B5
    texts = {}
    for mode, kernel in (("auto", "wave_histogram"),
                         ("pallas_ct", "wave_partition_hist"),
                         ("pallas", "wave_histogram_rowmajor"),
                         ("exact", "leaf_histogram")):
        p = (dict(p1023, tpu_growth="exact", tpu_histogram_mode="pallas")
             if mode == "exact" else dict(p1023, tpu_histogram_mode=mode))
        label = "wide-" + mode
        booster, launches, got = run(label, p, data_w, kernel)
        learner = booster._gbdt.learner
        need(learner.X.dtype == torch.uint16, "%s: X is %s"
             % (label, learner.X.dtype))
        need(mode != "auto" or learner.hist_mode == "pallas_t",
             "wide-auto resolved to %s, not pallas_t" % learner.hist_mode)
        for k in HIST_KERNELS[:4]:
            need(got[k + "_uint16"] == launches[k],
                 "%s: %d of %d %s launches uint16" % (
                     label, got[k + "_uint16"], launches[k], k))
        texts[mode] = booster.model_to_string()
        del booster, learner
        torch.cuda.empty_cache()
        twin(label, p, data_w, kernel, texts[mode])
    need(texts["auto"] == texts["pallas_ct"] == texts["pallas"],
         "max_bin 1023: the wave dataflows' texts differ")
    say("13d max_bin 1023: fused and staged text equal on B3 (auto), B1, "
        "B4 and B5; B3, B1 and B4 give one text to the byte; valid AUC "
        "%.6f (wave), %.6f (exact); phase 4 at max_bin 63: %.6f"
        % (AUCS["wide-auto"], AUCS["wide-exact"], AUCS["wave"]))
    del ds_w, dv_w, data_w
    torch.cuda.empty_cache()

    # ---- 13g. max_bin 255 (the port's default): byte bins through the
    # slot-ordered pass, B3 (auto) and B1 (pallas_ct) fused, one text
    data_b = (ds255, lgb.Dataset(Xv, label=yv, reference=ds255).construct(),
              Xw, Xv, yv)
    texts255 = {}
    for mode, kernel in (("auto", "wave_histogram"),
                         ("pallas_ct", "wave_partition_hist")):
        booster, _, _ = run("wide255-" + mode,
                            dict(p255, tpu_histogram_mode=mode), data_b,
                            kernel)
        texts255[mode] = booster.model_to_string()
        del booster
        torch.cuda.empty_cache()
    need(texts255["auto"] == texts255["pallas_ct"],
         "max_bin 255: B3's and B1's texts differ")
    say("13g max_bin 255: B3 (auto) and B1 (pallas_ct) give one text to "
        "the byte; valid AUC %.6f" % AUCS["wide255-auto"])
    del ds255, t255, data_b
    torch.cuda.empty_cache()

    # ---- 13e. tpu_use_dp: the f64 forms, the gather
    dp = dict(params, tpu_use_dp=True)
    dp_texts = {}
    for label, p, kernel in (
            ("dp", dp, "wave_partition_hist"),
            ("dp-pallas", dict(dp, tpu_histogram_mode="pallas",
                               tpu_growth="wave"), "wave_histogram_rowmajor"),
            ("dp-exact", dict(dp, tpu_growth="exact",
                              tpu_histogram_mode="pallas"),
             "leaf_histogram")):
        booster, launches, got = run(label, p, data, kernel, updates=0)
        gb = booster._gbdt
        need(gb.score_dtype == torch.float64 and gb._score_engine
             == "gather", "%s: scores %s, engine %s"
             % (label, gb.score_dtype, gb._score_engine))
        for k in HIST_KERNELS[:4]:
            need(got[k + "_f64"] == launches[k],
                 "%s: %d of %d %s launches f64" % (
                     label, got[k + "_f64"], launches[k], k))
        dp_texts[label] = booster.model_to_string()
        del booster, gb
        torch.cuda.empty_cache()
    twin("dp", dp, data, "wave_partition_hist", dp_texts["dp"], updates=0)
    need(dp_texts["dp"] == dp_texts["dp-pallas"],
         "tpu_use_dp: pallas_ct and pallas texts differ")
    need(dp_texts["dp"] != main_text, "tpu_use_dp: the f32 main text")
    say("13e tpu_use_dp: fused and staged text equal; pallas_ct and pallas "
        "one text; valid AUC %.6f (the f32 main path %.6f), exact %.6f"
        % (AUCS["dp"], AUCS["wave"], AUCS["dp-exact"]))

    # ---- 13f. the XLA engines and the gather; exact growth on the
    # first ENGINE_EXACT_ROWS rows (a full-N masked pass a split), beside
    # B5's run on them
    sub = np.arange(min(ENGINE_EXACT_ROWS, len(Xt_raw)))
    ds_s = ds.subset(sub).construct()
    data_s = (ds_s, lgb.Dataset(Xv, label=yv, reference=ds_s).construct(),
              Xt_raw[sub], Xv, yv)
    exact_p = dict(params, tpu_growth="exact", tpu_histogram_mode="pallas")
    booster, _, _ = run("exact-subset", exact_p, data_s, "leaf_histogram")
    exact_sub_text = booster.model_to_string()
    del booster
    eng_texts = {}
    for mode in ("scatter", "onehot"):
        for growth in ("wave", "exact"):
            label = "%s-%s" % (mode, growth)
            p = dict(params, tpu_histogram_mode=mode, tpu_growth=growth)
            booster, _, _ = run(label, p,
                                data_s if growth == "exact" else data, None)
            need(booster._gbdt.learner.hist_mode == mode, "%s: mode %s"
                 % (label, booster._gbdt.learner.hist_mode))
            eng_texts[label] = booster.model_to_string()
            del booster
            torch.cuda.empty_cache()
            if growth == "wave":
                twin(label, p, data, None, eng_texts[label])
    need(eng_texts["scatter-wave"] == main_text,
         "scatter (wave): not the main path's text")
    need(eng_texts["scatter-exact"] == exact_sub_text,
         "scatter (exact): not exact growth's (B5) text on the same rows")
    booster, _, _ = run("gather", dict(params, tpu_score_update="gather"),
                        data, "wave_partition_hist", updates=0)
    need(booster.model_to_string() == main_text,
         "gather: not the main path's text")
    del booster
    torch.cuda.empty_cache()
    say("13f engines: scatter gives the main path's and exact growth's "
        "texts to the byte, onehot fused = staged; valid AUC onehot "
        "%.6f / %.6f, scatter %.6f / %.6f (wave / exact); gather: the "
        "main text, B2 never launched"
        % (AUCS["onehot-wave"], AUCS["onehot-exact"], AUCS["scatter-wave"],
           AUCS["scatter-exact"]))
    say("rates on %s, whole-call / steady it/s: max_bin 1023 auto %.4f / "
        "%.4f (staged %.4f / %.4f), pallas_ct %.4f / %.4f (%.4f / %.4f), "
        "pallas %.4f / %.4f (%.4f / %.4f), exact %.4f / %.4f (%.4f / %.4f); "
        "tpu_use_dp %.4f / %.4f (%.4f / %.4f), pallas %.4f / %.4f, exact "
        "%.4f / %.4f; scatter wave %.4f / %.4f (%.4f / %.4f), exact %.4f / "
        "%.4f; onehot wave %.4f / %.4f (%.4f / %.4f), exact %.4f / %.4f; "
        "gather %.4f / %.4f (exact growth of the XLA engines on %d rows; "
        "B5 there %.4f / %.4f)"
        % ((card,) + sum((RATES[k] for k in (
            "wide-auto", "wide-auto-staged", "wide-pallas_ct",
            "wide-pallas_ct-staged", "wide-pallas", "wide-pallas-staged",
            "wide-exact", "wide-exact-staged", "dp", "dp-staged",
            "dp-pallas", "dp-exact", "scatter-wave", "scatter-wave-staged",
            "scatter-exact", "onehot-wave", "onehot-wave-staged",
            "onehot-exact", "gather")), ()) + (len(sub),)
           + RATES["exact-subset"]))
    say("phase 13 (uint16 bins, f64, the XLA engines): %.1f s"
        % (time.perf_counter() - t_phase))
    return records, paths, forms


# ------------------------------------------------------------- phase 14
# rows of 14b's dense copy of the Bosch recipe (its raw rows are what
# DART, rollback and continued training score a tree on)
RAW_SPARSE_ROWS = 5_000
DART_ITERS = 10
COORD_EXACT_ITERS = 3
# rows of 14c's watchdog and incident drills
DRILL_ROWS = 20_000
# 14c's iterations: the sampling profiler's window must hold enough
# samples for its self-measured overhead to read true (at 5 iterations,
# ~0.6 s and ~17 samples, one slow sample moves it by half its budget)
OBS_ITERS = 25
# 14d: requests of each closed loop (phase 7's 5,000 run twice more
# would take 20 s), the drift monitor's cadence and window (rows)
SERVE_OBS_REQUESTS = 2_000
DRIFT_EVERY = 16_384
DRIFT_WINDOW = 65_536


def coord_store_phase(lgb, kernels, card, sparse_data):
    """14a: the coordinate store (tpu_sparse=true, tpu_sparse_kernel=
    false) on phase 5's Bosch-shaped Dataset: wave growth (W = 32) fused,
    fused again and staged, then exact growth fused.  No kernel of the
    port runs its histograms (the JAX package's segment sums are plain
    torch here too): B6 must not launch, B2 once an iteration.  The three
    wave texts must be one, and phase 5's entry-chunk text.  Returns the
    fused wave run's launches."""
    import torch
    t_phase = time.perf_counter()
    ds, dv, chunk_text, chunk_bytes = sparse_data
    params = dict(sparse_params(), tpu_sparse_kernel=False)
    runs = {}
    for label, p, iters, growth in (
            ("coord", params, ITERS, "wave"),
            ("coord-again", params, ITERS, "wave"),
            ("coord-staged", dict(params, tpu_fused_iter="off"), ITERS,
             "wave"),
            ("coord-exact", dict(params, tpu_growth="exact"),
             COORD_EXACT_ITERS, "exact")):
        stamps = []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        evals = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        booster, launches = counted(kernels, lambda: lgb.train(
            p, ds, iters, valid_sets=[dv], evals_result=evals,
            callbacks=[stamp]))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        learner = booster._gbdt.learner
        stats = booster.grow_stats()
        need(learner.hist_mode == "sparse" and learner.growth == growth,
             "%s: ran %s under %s growth" % (label, learner.hist_mode,
                                              learner.growth))
        need((fused_of(booster) is None) == label.endswith("staged"),
             "%s: took the other chain" % label)
        need(len(stats) == iters, "%s: grew %d trees" % (label, len(stats)))
        need(launches["score_update"] == iters
             and sum(launches.values()) == iters,
             "%s: launches %s (B2 once an iteration and nothing else)"
             % (label, launches))
        auc = evals["valid_0"]["auc"][-1]
        need(auc > 0.8, "%s: valid AUC %.4f <= 0.8" % (label, auc))
        steady = ((len(stamps) - 1) / (stamps[-1] - stamps[0])
                  if len(stamps) > 1 else float("nan"))
        RATES[label] = (iters / t_train, steady)
        unit = "splits" if growth == "exact" else "waves"
        say("%s train on %s: %d iterations in %.3f s including set-up "
            "(%.4f it/s); steady %.4f it/s; %.2f %s/tree, %.2f host "
            "reads/tree; valid AUC %.6f; store %.1f MB on the device "
            "(the entry-chunk store's %.1f MB); peak device memory %.2f GB"
            % (label, card, iters, t_train, iters / t_train, steady,
               sum(s.passes for s in stats) / len(stats), unit,
               sum(s.host_reads for s in stats) / len(stats), auc,
               learner.sparse_device_bytes / 1e6, chunk_bytes / 1e6,
               torch.cuda.max_memory_allocated() / 1e9))
        runs[label] = (booster.model_to_string(), launches)
        del booster
        torch.cuda.empty_cache()
    text = runs["coord"][0]
    need(runs["coord-again"][0] == text,
         "14a: two fused runs gave different model texts")
    need(runs["coord-staged"][0] == text,
         "14a: fused and staged model texts differ")
    need(text == chunk_text, "14a: the coordinate store's model text "
         "differs from the entry-chunk store's (phase 5)")
    say("14a checks: fused, fused again and staged model text one to the "
        "byte, and phase 5's entry-chunk text; %.1f s"
        % (time.perf_counter() - t_phase))
    return runs["coord"][1]


def raw_modes_phase(lgb, kernels, card):
    """14b: DART, a rollback and continued training on both sparse stores
    from the raw rows: the Bosch recipe's first RAW_SPARSE_ROWS rows as a
    dense matrix (the rows the host traversal scores a tree on), its
    valid rows likewise; the scores must follow the trees.  EFB is off:
    a bundle's conflicting rows make binned scores differ from the raw
    rows' (ROADMAP C, standing notes), which would hide what the check
    holds.  Returns the entry-chunk DART run's launches."""
    import torch
    t_phase = time.perf_counter()
    Xs, ys = make_sparse_data(RAW_SPARSE_ROWS, 7)
    Xsv, ysv = make_sparse_data(RAW_SPARSE_ROWS // 4, 8)
    X, Xv = Xs.toarray(), Xsv.toarray()
    base_params = dict(sparse_params(), enable_bundle=False)
    ds = lgb.Dataset(X, label=ys, params=base_params).construct()
    dv = lgb.Dataset(Xv, label=ysv, reference=ds).construct()
    need(ds._handle.raw_data is not None and ds._handle.bundle is None,
         "14b: the raw rows were not kept, or EFB bundled")
    out = {}
    for store, kernel in (("coord", False), ("chunked", True)):
        p = dict(base_params, tpu_sparse_kernel=kernel)
        mode = "sparse_mxu" if kernel else "sparse"
        t0 = time.perf_counter()
        dart, launches = counted(kernels, lambda: lgb.train(
            dict(p, boosting="dart", drop_rate=0.1), ds, DART_ITERS,
            valid_sets=[dv]))
        need(dart._gbdt.learner.hist_mode == mode, "14b: dart on %s" % mode)
        check_scores_follow_trees("dart-" + store, dart, X, Xv)
        out["dart-" + store] = launches
        # staged: the checks are the scores, not the graphs
        p = dict(p, tpu_fused_iter="off")
        rb = lgb.train(p, ds, 4, valid_sets=[dv])
        n = rb.num_trees()
        rb.rollback_one_iter()
        need(rb.num_trees() == n - 1, "14b: rollback kept %d of %d trees"
             % (rb.num_trees(), n))
        check_scores_follow_trees("rollback-" + store, rb, X, Xv)
        base = lgb.train(p, ds, 2)
        cont = lgb.train(p, ds, 2, init_model=base, valid_sets=[dv])
        need(cont.num_trees() == base.num_trees() + 2,
             "14b: continued training grew %d trees"
             % (cont.num_trees() - base.num_trees()))
        check_scores_follow_trees("init_model-" + store, cont, X, Xv)
        say("14b %s store on %s: DART (%d iterations, drop_rate 0.1) "
            "launches %s, a rollback, continued training from init_model; "
            "scores follow the trees; %.1f s"
            % (store, card, DART_ITERS, launches,
               time.perf_counter() - t0))
        del dart, rb, base, cont
        torch.cuda.empty_cache()
    say("14b: %.1f s" % (time.perf_counter() - t_phase))
    return out["dart-chunked"]


def observers_phase(lgb, kernels, card, data, main_text):
    """14c: the main path (phase 4's Dataset, fused, OBS_ITERS
    iterations) with every single-process observer on, and off, in the
    same call: one model text to the byte, each run's steady rate; the
    timeline passes `obs recompiles --check`, `obs roofline` and `obs prof
    --check` and validates; the live plane is scraped from a thread
    during the run (plain HTTP: no TLS context is built beside the
    sampler).
    Then on DRILL_ROWS rows: a stalled callback makes the watchdog write
    a flight record, and a fobj with one NaN opens an incident.  Returns
    the observed run's launches."""
    import contextlib
    import http.client
    import io
    import shutil
    import tempfile
    import threading
    import torch
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.obs.events import read_events, validate_event
    from lightgbm_tpu_torch.obs.ledger import Ledger
    t_phase = time.perf_counter()
    ds, dv = data[0], data[1]
    work = tempfile.mkdtemp(prefix="chip_smoke_observers_")
    path = os.path.join(work, "run.jsonl")
    on = dict(flagship_params(), obs_events_path=path, obs_compile=True,
              obs_utilization_every=1, obs_watchdog_secs=120.0,
              obs_incident=True, obs_http_port=0,
              obs_ledger_dir=os.path.join(work, "ledger"))
    scraped = {}

    def scrape(url):
        host, port = url[len("http://"):].rsplit(":", 1)
        for route in ("/healthz", "/metrics", "/statusz"):
            conn = http.client.HTTPConnection(host, int(port), timeout=30)
            try:
                conn.request("GET", route)
                r = conn.getresponse()
                scraped[route] = (r.status, len(r.read()))
            finally:
                conn.close()

    texts, threads = {}, []
    launches = None
    for label, p in (("observers-off", flagship_params()),
                     ("observers-on", on)):
        stamps = []

        def stamp(env, label=label):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            url = env.model._gbdt._obs.live_url
            if url and not threads:
                threads.append(threading.Thread(target=scrape, args=(url,)))
                threads[0].start()

        t0 = time.perf_counter()
        booster, got = counted(kernels, lambda: lgb.train(
            p, ds, OBS_ITERS, valid_sets=[dv], callbacks=[stamp]))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=60)
        need(fused_of(booster) is not None, "%s: did not run fused" % label)
        steady = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        RATES[label] = (OBS_ITERS / t_train, steady)
        say("%s train on %s: %d iterations in %.3f s including set-up "
            "(%.4f it/s); steady %.4f it/s over iterations 2-%d; launches "
            "%s" % (label, card, OBS_ITERS, t_train, OBS_ITERS / t_train,
                    steady, OBS_ITERS, got))
        texts[label] = booster.model_to_string()
        if label == "observers-on":
            launches = got
        del booster
        torch.cuda.empty_cache()
    need(texts["observers-on"] == texts["observers-off"],
         "14c: the observed run's model text differs from the unobserved "
         "run's")
    # the drift_fingerprint= line carries each run's own scores (25
    # iterations here, ITERS there): the trees are compared without it
    first = without_fp(texts["observers-off"]).split("Tree=%d" % ITERS)[0]
    need(without_fp(main_text).startswith(first.rstrip("\n")),
         "14c: the first %d trees differ from the main path's" % ITERS)
    need(set(scraped) == {"/healthz", "/metrics", "/statusz"}
         and all(code == 200 for code, _ in scraped.values()),
         "14c: live plane scrape %s" % scraped)
    events = read_events(path)
    for e in events:
        validate_event(e, strict=True)
    attrs = [e for e in events if e["ev"] == "compile_attr"]
    names = sorted({e["entry"] for e in attrs})
    need({"fused_iter.tree", "fused_iter.score"} <= set(names),
         "14c: captures on the timeline: %s" % names)
    need(all(e.get("cost") for e in attrs
             if e["entry"] == "fused_iter.tree"),
         "14c: the tree graph's capture has no cost")
    util = [e for e in events if e["ev"] == "utilization"]
    need(util, "14c: no utilization event")
    profs = [e for e in events if e["ev"] == "prof_profile"]
    need(profs, "14c: no prof_profile window")
    need(len(Ledger(on["obs_ledger_dir"]).entries()) == 1,
         "14c: the run is not in the ledger")
    outs = {}
    for cmd in (["recompiles", path, "--check"], ["roofline", path],
                ["prof", path, "--check"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["obs"] + cmd)
        outs[cmd[0]] = buf.getvalue()
        need(rc == 0, "14c: obs %s exited %d:\n%s"
             % (" ".join(cmd), rc, buf.getvalue()))
    for ln in outs["roofline"].splitlines()[:8]:
        say("  " + ln)
    last = util[-1] if util else {}
    say("14c observers on %s: steady %.4f it/s on, %.4f off (%.2f%%); %d "
        "events, captures %s; utilization flop %.6f, hbm %.6f, bound %s; "
        "%d profile windows, overhead %s; live plane scraped %s; ledger "
        "1 record" % (card, RATES["observers-on"][1],
                      RATES["observers-off"][1],
                      100.0 * (RATES["observers-off"][1]
                               / RATES["observers-on"][1] - 1.0),
                      len(events), names, last.get("flop_util", 0.0),
                      last.get("hbm_util", 0.0), last.get("bound"), len(profs),
                      [round(p.get("overhead_frac", 0.0), 5)
                       for p in profs], sorted(scraped)))

    # ---- the drills, on DRILL_ROWS rows of the flagship data
    Xd, yd = data[2][:DRILL_ROWS], ds._handle.metadata.label[:DRILL_ROWS]
    drill = lgb.Dataset(Xd, label=yd, params=flagship_params())
    wpath = os.path.join(work, "stall.jsonl")

    def stall(env):
        if env.iteration == 1:
            time.sleep(3.0)

    lgb.train(dict(flagship_params(), obs_events_path=wpath,
                   obs_watchdog_secs=1.0), drill, 3, callbacks=[stall])
    flight = wpath + ".flight.json"
    need(os.path.exists(flight), "14c: the stalled run left no flight "
         "record")
    rec = json.load(open(flight))
    need(rec.get("threads") and rec.get("devices"),
         "14c: flight record without thread stacks or device memory")
    ipath = os.path.join(work, "nan.jsonl")

    def fobj(preds, train_data):
        p = 1.0 / (1.0 + np.exp(-preds))
        g = p - train_data.get_label()
        g[0] = np.nan
        return g, p * (1.0 - p)

    lgb.train(dict(flagship_params(), objective="none", metric="none",
                   obs_events_path=ipath, obs_health="warn",
                   obs_incident=True),
              lgb.Dataset(Xd, label=yd, params=flagship_params()), 2,
              fobj=fobj)
    ievents = read_events(ipath)
    opens = [e for e in ievents if e["ev"] == "incident_open"]
    need(len(opens) == 1, "14c: a NaN gradient opened %d incidents"
         % len(opens))
    say("14c drills: a %d-row run stalled 3 s under obs_watchdog_secs=1 "
        "wrote a flight record (%s: %d threads); a fobj with one NaN "
        "opened incident %s (trigger %s); %.1f s in 14c"
        % (DRILL_ROWS, rec.get("reason"), len(rec["threads"]),
           opens[0]["id"], opens[0]["trigger"],
           time.perf_counter() - t_phase))
    shutil.rmtree(work, ignore_errors=True)
    return launches


def serve_observer_phase(lgb, card, booster, X):
    """14d (inside phase 7): its booster serves its fresh rows X under
    bench_serve.py's closed loop, first with no observer, then with a
    run observer, drift monitoring against the training data's
    fingerprint (DRIFT_EVERY rows, a DRIFT_WINDOW window) and the live
    plane: p50 and p99 of each; no capture after warm-up; in-distribution
    traffic raises no drift alert, a shifted feature raises one."""
    import shutil
    import tempfile
    import urllib.request
    from lightgbm_tpu_torch.obs import observer_from_config
    from lightgbm_tpu_torch.obs.events import read_events, validate_event
    from lightgbm_tpu_torch.utils.config import Config
    t_phase = time.perf_counter()
    need(booster._gbdt.drift_fingerprint() is not None,
         "14d: phase 7's booster has no drift fingerprint")
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_obs_")
    path = os.path.join(work, "serve.jsonl")
    ladder = [1 << b for b in range(6, 13)]
    lat = {}
    for label in ("no observer", "observer"):
        obs, over = None, {}
        if label == "observer":
            obs = observer_from_config(Config({
                "obs_events_path": path, "obs_compile": True,
                "obs_http_port": 0}))
            obs.ensure_live_server(0)
            over = {"observer": obs, "drift_every": DRIFT_EVERY,
                    "drift_window": DRIFT_WINDOW}
        sp = booster.serve(max_batch=SERVE_MAX_BATCH, max_delay_ms=2.0,
                           **over)
        try:
            need(sp.warmup(ladder) == ladder, "14d: warm-up ladder")
            lt, wall, rows, _ = run_load(sp, X, SERVE_OBS_REQUESTS,
                                         SERVE_THREADS, SERVE_SIZES)
            st = sp.stats()
            need(st["executables"]["steady_state_compiles"] == 0,
                 "14d (%s): a graph was captured after warm-up" % label)
            lat[label] = (float(np.percentile(lt, 50)),
                          float(np.percentile(lt, 99)), len(lt) / wall)
            if label == "observer":
                need(sp.drift is not None, "14d: no drift monitor")
                with urllib.request.urlopen(obs.live_url + "/statusz",
                                            timeout=30) as r:
                    statusz = json.loads(r.read())
                need(sp.drift.alerts_fired == 0,
                     "14d: in-distribution traffic raised a drift alert: "
                     "%s" % sp.drift.headline())
                shifted = X[:SERVE_MAX_BATCH].copy()
                shifted[:, 0] += 3.0
                for _ in range(2 * DRIFT_WINDOW // SERVE_MAX_BATCH):
                    sp.predict(shifted)
                need(sp.drift.alerting and sp.drift.alerts_fired == 1,
                     "14d: the shifted feature raised no drift alert: %s"
                     % sp.drift.headline())
                head = sp.drift.headline()
        finally:
            sp.close()
            if obs is not None:
                obs.close()
    events = read_events(path)
    for e in events:
        validate_event(e, strict=True)
    caps = sorted(e["entry"] for e in events if e["ev"] == "compile")
    need(len(caps) == len(ladder) and all(
        c.startswith("serve_predict_b") for c in caps),
        "14d: serving captures on the timeline %s" % caps)
    drifts = [e for e in events if e["ev"] == "drift"]
    need(drifts and drifts[-1].get("alert") == "firing",
         "14d: no firing drift event on the timeline")
    need(any(e["ev"] == "serve_summary" for e in events),
         "14d: no serve_summary event")
    say("14d serving phase 7's model on %s, %d threads: no observer p50 "
        "%.6f s, p99 %.6f s, %.1f requests/s; observer + drift + live "
        "plane p50 %.6f s, p99 %.6f s, %.1f requests/s; no capture after "
        "warm-up; %d drift evaluations, in-distribution clean, the shifted "
        "feature fired (psi_max %s); /statusz lifecycle %s; %.1f s"
        % ((card, SERVE_THREADS) + lat["no observer"] + lat["observer"]
           + (len(drifts), head.get("last", {}).get("psi_max"),
              statusz.get("lifecycle"), time.perf_counter() - t_phase)))
    shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------- phase 15
# 15b/15c: the rank processes' counts of every kernel wrapper, by name
# (the deferred-finish forms apart)
DIST_RANKS = 2
DIST_SMALL_ROWS = 200_000
# 15c's iterations: the feature-parallel, voting (top_k 28) and
# data-parallel exact runs and their serial twin 2, voting with top_k 5
# 1 (each split of exact growth makes one or two collectives, ~4 ms each
# through gloo on one card), which keeps the phase within its time
DIST_SMALL_ITERS = 2


def wrapper_counts():
    """Every launch counter of the kernel wrappers (fused_iter.COUNTERS),
    by name: a wrapper's launches, and a form's as name_form."""
    from lightgbm_tpu_torch.ops import fused_iter as fi
    return {k.__name__ + ("" if form is None else "_" + form): n
            for (k, form), n in zip(fi.COUNTERS, fi._counts())}


def zero_counts():
    from lightgbm_tpu_torch.ops import fused_iter as fi
    fi._set_counts([0] * len(fi.COUNTERS), [0] * len(fi.COUNTERS))


def dist_kernel_phase(X_t, default_bin, wk, lh):
    """15a: the deferred-finish forms of B1, B3, B4 and B5 over two
    disjoint row sets (the first and the second half of the rows, the
    other half's leaf ids set to -1), their int64 sums added and
    converted by the finish alone, bit-equal to one launch over the
    union; then each form and the finish timed.  Returns the records."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import weight_rows
    dev = X_t.device
    F, N = X_t.shape
    B, K = 63, 32
    g = torch.Generator(device="cpu").manual_seed(15)
    lid = torch.randint(0, K, (N,), generator=g, dtype=torch.int32)
    w3 = torch.randn((N, 3), generator=g, dtype=torch.float32)
    f_w = torch.randint(0, F, (K,), generator=g)
    cols = torch.stack([
        torch.ones(K), f_w.float(),
        torch.randint(0, B - 1, (K,), generator=g).float(),
        torch.zeros(K), default_bin.cpu()[f_w].float(),
        torch.randint(0, 2, (K,), generator=g).float(),
        torch.arange(K, 2 * K).float(), torch.zeros(K), torch.zeros(K),
        torch.full((K,), float(B))], dim=-1).contiguous()
    psrc = torch.arange(K, dtype=torch.int32)
    cid = torch.where(torch.randint(0, 2, (K,), generator=g) > 0,
                      psrc + K, psrc).to(torch.int32)
    lid, w3, cols, psrc, cid = (t.to(dev) for t in (lid, w3, cols, psrc,
                                                    cid))
    exps = wk.fixed_point_exponents(w3)
    half = torch.arange(N, device=dev) < N // 2
    parts = [torch.where(m, lid, torch.full_like(lid, -1))
             for m in (half, ~half)]
    X = X_t.t().contiguous()
    records = {}

    # B1: routing and the sums; the rows of each half keep their own
    # routed ids
    new_u, hist_u = wk.wave_partition_hist(X_t, lid, w3, cid, cols, psrc, B,
                                           exps=exps)
    outs = [wk.wave_partition_hist(X_t, p, w3, cid, cols, psrc, B,
                                   exps=exps, finish=False) for p in parts]
    outs = [(a, s.clone()) for a, s in outs]
    need(outs[0][1].dtype == torch.int64, "B1 deferred: sums not int64")
    got = wk.finish_hist(outs[0][1] + outs[1][1], cid, exps)
    need(torch.equal(got, hist_u), "15a: B1's summed halves differ from "
         "one launch over the union")
    need(torch.equal(torch.where(half, outs[0][0], outs[1][0]), new_u),
         "15a: B1's routed ids of the halves differ from the union's")
    checks = [("wave_partition_hist_deferred", None)]
    # B3 and B4 on the routed ids, the same child ids
    for name, fn, Xk in (("wave_histogram_deferred", wk.wave_histogram,
                          X_t),
                         ("wave_histogram_rowmajor_deferred",
                          wk.wave_histogram_rowmajor, X)):
        one = fn(Xk, new_u, w3, cid, B, exps=exps)
        halves = [fn(Xk, torch.where(m, new_u, torch.full_like(new_u, -1)),
                     w3, cid, B, exps=exps, finish=False).clone()
                  for m in (half, ~half)]
        need(torch.equal(wk.finish_hist(halves[0] + halves[1], cid, exps),
                         one), "15a: %s halves differ from the union" % name)
        need(torch.equal(one, hist_u), "15a: %s is not B1's histogram"
             % name)
        checks.append((name, fn))
    # B5: one leaf of a 64-leaf state, the grower's weight rows
    lid5 = torch.randint(0, 64, (N,), generator=g,
                         dtype=torch.int32).to(dev)
    w35 = weight_rows(torch.randn(N, generator=g).to(dev),
                      (torch.rand(N, generator=g) + 0.05).to(dev),
                      torch.ones(N, device=dev))
    e5 = wk.fixed_point_exponents(w35)
    leaf = torch.full((1,), 5, dtype=torch.int32, device=dev)
    one5 = lh.leaf_histogram(X, None, None, lid5, leaf, None, B, w3=w35,
                             exps=e5)
    halves5 = [lh.leaf_histogram(
        X, None, None, torch.where(m, lid5, torch.full_like(lid5, -1)),
        leaf, None, B, w3=w35, exps=e5, finish=False).clone()
        for m in (half, ~half)]
    need(torch.equal(wk.finish_hist(halves5[0] + halves5[1], leaf, e5)[0],
                     one5), "15a: B5's summed halves differ from the union")
    say("15a: B1, B3, B4 and B5 deferred-finish sums of the two halves of "
        "%d rows, added as int64 and converted by the finish alone, equal "
        "one launch over the union to the bit (max_abs_err 0)" % N)

    slot, n_act = slots_of(new_u, cid)
    lib_ms = bincount_ms(X_t, slot, w3, B)
    for name, fn in checks:
        if fn is None:
            ms = time_ms(lambda: wk.wave_partition_hist(
                X_t, lid, w3, cid, cols, psrc, B, exps=exps, finish=False))
            plain = time_ms(lambda: wk.wave_partition_hist_plain(
                X_t, lid, w3, cid, cols, psrc, B))
            nbytes = (N * (4 + 4 + 1) + n_act * (F + 12) + K * (10 * 4 + 8)
                      + K * F * B * 3 * 8)
        else:
            Xk = X_t if fn is wk.wave_histogram else X
            plainfn = (wk.wave_histogram_plain if fn is wk.wave_histogram
                       else wk.wave_histogram_rowmajor_plain)
            ms = time_ms(lambda: fn(Xk, new_u, w3, cid, B, exps=exps,
                                    finish=False))
            plain = time_ms(lambda: plainfn(Xk, new_u, w3, cid, B))
            nbytes = N * 4 + n_act * (F + 12) + K * (4 + F * B * 3 * 8)
        records[name] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib_ms,
            shape="N=%d F=%d B=%d K=%d, %d rows in a child slot; the sums "
                  "of two halves bit-equal to the union" % (N, F, B, K,
                                                            n_act),
            nbytes=nbytes, flops=3 * n_act * F)
    rows5 = int((lid5 == 5).sum())
    s5 = torch.where(lid5 == 5, 0, -1)
    records["leaf_histogram_deferred"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: lh.leaf_histogram(X, None, None, lid5, leaf,
                                             None, B, w3=w35, exps=e5,
                                             finish=False)),
        plain_ms=time_ms(lambda: wk.wave_histogram_rowmajor_plain(
            X, lid5, w35, leaf, B)),
        library_ms=bincount_ms(X_t, s5, w35, B),
        shape="N=%d F=%d B=%d, one leaf of 64 (%d rows); one-scan plan %s; "
              "halves bit-equal to the union"
              % (N, F, B, rows5, tuple(lh.leaf_plan(F, B))),
        nbytes=N * 4 + rows5 * (F + 12) + F * B * 3 * 8,
        flops=3 * rows5 * F)
    # the finish alone: K x F x B x 3 int64 sums to f32; its plain
    # version scales the sums in float64 and rounds to f32
    sums = outs[0][1] + outs[1][1]
    plain_fin = (torch.ldexp(sums.double(), -exps.double()).float())
    fin = wk.finish_hist(sums, cid, exps)
    records["finish_hist"] = dict(
        max_abs_err=float((fin - plain_fin).abs().max()),
        ms=time_ms(lambda: wk.finish_hist(sums, cid, exps)),
        plain_ms=time_ms(lambda: torch.ldexp(sums.double(),
                                             -exps.double()).float()),
        library_ms=None,
        shape="K=%d F=%d B=%d: %d int64 sums to f32" % (K, F, B,
                                                        sums.numel()),
        nbytes=sums.numel() * (8 + 4), flops=sums.numel())
    need(records["finish_hist"]["max_abs_err"]
         <= 1e-6 * float(fin.abs().max()) + 1e-12,
         "15a: the finish differs from its plain version beyond f32 "
         "rounding")
    for name, r in records.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("flops"))
        say("%-34s %9.4f ms  plain %9.4f ms  library %s  bound %.4f ms "
            "(%s)  max_abs_err %g  [%s]"
            % (name, r["ms"], r["plain_ms"],
               "%.4f ms" % r["library_ms"] if r["library_ms"] is not None
               else "none", r["bound_ms"], r["bound_by"], r["max_abs_err"],
               r["shape"]))
    return records


def phase15_rank(comm, payload):
    """One rank of phase 15 (parallel/launch.py runs it in a process of
    its own on cuda:0, over gloo): each of payload's runs trains through
    lightgbm_tpu_torch.train on this rank's Dataset, every launch counter
    set to 0 just before and read just after (a run's ``save_dir``:
    rank 0 saves its Dataset there first, its mappers with its rows).
    Returns, a run, the counts, the model text (rank 0) and its digest,
    the reduced valid metric, the steady rate and the collectives'
    traffic."""
    import hashlib
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.dataset import TrainingData
    from lightgbm_tpu_torch.parallel.comm import rank_device
    from lightgbm_tpu_torch.utils.config import Config
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    out = {"rank": comm.rank, "backend": comm.backend, "device": str(dev),
           "runs": {}}
    gen = int(payload["gen_rows"])
    # phase 4's rows and valid rows, made again from their seed
    X, y = make_data(gen + VALID_ROWS)
    for run in payload["runs"]:
        params, rows = run["params"], int(run["rows"])
        feature = params.get("tree_learner") == "feature"
        lo, hi = ((0, rows) if feature
                  else (comm.rank * rows // comm.size,
                        (comm.rank + 1) * rows // comm.size))
        if run.get("binned_dir"):
            ds = lgb.Dataset.from_binned(run["binned_dir"], params=params,
                                         comm=comm)
        else:
            ds = lgb.Dataset(X[lo:hi], label=y[lo:hi], params=params)
            ds._handle = TrainingData.from_matrix(
                X[lo:hi], label=y[lo:hi], config=Config(dict(params)),
                comm=comm)
        if run.get("save_dir") and comm.rank == 0:
            ds._handle.save_binned(run["save_dir"])
        valid, evals = [], {}
        if run.get("valid"):
            vlo, vhi = (comm.rank * VALID_ROWS // comm.size,
                        (comm.rank + 1) * VALID_ROWS // comm.size)
            valid = [lgb.Dataset(X[gen + vlo:gen + vhi],
                                 label=y[gen + vlo:gen + vhi],
                                 reference=ds)]
        stamps = []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        comm.stats.update(calls=0, bytes=0, seconds=0.0, host_seconds=0.0)
        zero_counts()
        t0 = time.perf_counter()
        iters = int(run.get("iters", ITERS))
        booster = lgb.train(params, ds, iters, valid_sets=valid or None,
                            evals_result=evals, callbacks=[stamp],
                            device=str(dev))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        counts = wrapper_counts()
        stats = list(booster.grow_stats())
        text = booster.model_to_string()
        waves = sum(s.passes + 1 for s in stats)
        res = {"counts": counts,
               "digest": hashlib.sha256(text.encode()).hexdigest(),
               "trees": len(stats), "leaves": [s.num_leaves for s in stats],
               "passes": [s.passes for s in stats],
               "steady_it_s": ((len(stamps) - 1) / (stamps[-1] - stamps[0])
                               if len(stamps) > 1 else float("nan")),
               "train_s": t_train,
               "collective_calls": comm.stats["calls"],
               "collective_bytes": comm.stats["bytes"],
               "collective_s": comm.stats["seconds"],
               "passes_and_roots": waves,
               "learner": type(booster._gbdt.learner).__name__,
               "rows": int(ds._handle.num_data)}
        if evals:
            res["reduced_valid"] = {k: v[-1] for k, v in
                                    evals["valid_0"].items()}
        if comm.rank == 0:
            res["text"] = text
        out["runs"][run["label"]] = res
        del booster
        torch.cuda.empty_cache()
    return out


def tree_blocks(text):
    """Each tree's {key: value} lines of a model text."""
    trees, cur = [], None
    for line in text.splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    return trees


def compare_splits(label, text, ref):
    """(trees whose split features and thresholds equal ref's, trees
    compared: the fewer of the two texts'); prints the first differing
    split's two gains."""
    a, b = tree_blocks(text), tree_blocks(ref)
    b = b[:len(a)]
    same = 0
    first = None
    for t, (x, z) in enumerate(zip(a, b)):
        keys = ("split_feature", "threshold")
        if all(x.get(k) == z.get(k) for k in keys):
            same += 1
        elif first is None:
            fa, fb = x.get("split_feature", "").split(), \
                z.get("split_feature", "").split()
            ta, tb = x.get("threshold", "").split(), \
                z.get("threshold", "").split()
            i = next((i for i in range(min(len(fa), len(fb)))
                      if fa[i] != fb[i] or ta[i] != tb[i]),
                     min(len(fa), len(fb)))
            ga = x.get("split_gain", "").split()
            gb = z.get("split_gain", "").split()
            first = (t, i, ga[i] if i < len(ga) else "-",
                     gb[i] if i < len(gb) else "-")
    say("%s: %d of %d trees split as the serial run's%s"
        % (label, same, len(b), "" if first is None else
           "; first difference tree %d split %d, gain %s (%s) against %s "
           "(serial)" % (first[0], first[1], first[2], label, first[3])))
    return same, len(b)


def dist_phase(args, lgb, card, data):
    """15b and 15c: two rank processes (parallel/launch.py) on the one
    card over gloo.  15b: the flagship at full width, rank r the r-th
    contiguous half of phase 4's rows through from_matrix(comm=), 5
    iterations staged, the valid rows split alike; its witness, a serial
    run on all the rows binned with rank 0's mappers.  15c: 200,000 of
    the rows, 2 ranks: feature-parallel (every rank all rows) against
    serial exact growth, and voting (top_k 28, top_k 5) and
    data-parallel exact growth on the ranks' halves of a directory saved
    from the serial Dataset (from_binned(comm=)).  Returns the launch
    counts by path."""
    import shutil
    import tempfile
    import torch
    from lightgbm_tpu_torch.io.dataset import TrainingData
    from lightgbm_tpu_torch.parallel.launch import run_ranks_subprocess
    from lightgbm_tpu_torch.utils.config import Config
    t0 = time.perf_counter()
    params = flagship_params()
    _, _, _, Xv, yv = data
    small = DIST_SMALL_ROWS
    exact = dict(params, tpu_growth="exact", tpu_histogram_mode="pallas")
    Xs = data[2][:small]
    ys = np.asarray(data[0]._handle.metadata.label)[:small]
    ds_small = lgb.Dataset(Xs, label=ys, params=exact).construct()
    serial_exact = lgb.train(exact, ds_small,
                             DIST_SMALL_ITERS).model_to_string()
    work = tempfile.mkdtemp(prefix="phase15_")
    binned = os.path.join(work, "small")
    ds_small.save_binned(binned)
    # rank 0's Dataset of the data-parallel run: its distributed mappers
    rank0 = os.path.join(work, "rank0")
    del ds_small
    torch.cuda.empty_cache()
    runs = [
        {"label": "dp-2rank", "rows": args.rows, "valid": True,
         "save_dir": rank0, "params": dict(params, tree_learner="data")},
        {"label": "feature-2rank", "rows": small, "iters": DIST_SMALL_ITERS,
         "params": dict(exact, tree_learner="feature")},
        {"label": "voting-2rank", "rows": small, "binned_dir": binned,
         "iters": DIST_SMALL_ITERS,
         "params": dict(exact, tree_learner="voting", top_k=28)},
        {"label": "voting-top5-2rank", "rows": small, "binned_dir": binned,
         "iters": 1, "params": dict(exact, tree_learner="voting", top_k=5)},
        {"label": "dp-exact-2rank", "rows": small, "binned_dir": binned,
         "iters": DIST_SMALL_ITERS,
         "params": dict(exact, tree_learner="data")}]
    out = run_ranks_subprocess(DIST_RANKS, "chip_smoke:phase15_rank",
                               {"runs": runs, "gen_rows": args.rows},
                               timeout=600, device="cuda",
                               log_dir=os.path.join(work, "logs"))
    say("15: %d rank processes on %s, backend %s (%s)"
        % (len(out), ", ".join(o["device"] for o in out), out[0]["backend"],
           card))
    need(all(o["backend"] == "gloo" for o in out),
         "15: two ranks on one card must run over gloo")
    by_path = {}
    for run in runs:
        label = run["label"]
        rs = [o["runs"][label] for o in out]
        need(len({r["digest"] for r in rs}) == 1,
             "%s: the ranks' model texts differ" % label)
        need(all(r["trees"] == run.get("iters", ITERS) for r in rs),
             "%s: grew %s trees" % (label, [r["trees"] for r in rs]))
        by_path[label] = rs[0]["counts"]
        r0 = rs[0]
        say("%s (%s): texts byte-equal on %d ranks; rows a rank %s; "
            "leaves %s; steady %.4f it/s a rank (rank 0; %s); train %.2f s "
            "with set-up; collectives %d calls, %d bytes, %.3f s host time "
            "a rank, %.3f ms a pass and %.0f bytes a tree; launches %s"
            % (label, r0["learner"], len(rs), [r["rows"] for r in rs],
               r0["leaves"], r0["steady_it_s"], card, r0["train_s"],
               r0["collective_calls"], r0["collective_bytes"],
               r0["collective_s"],
               1e3 * r0["collective_s"] / max(r0["passes_and_roots"], 1),
               r0["collective_bytes"] / max(r0["trees"], 1),
               {k: v for k, v in r0["counts"].items() if v}))
    # 15b: B1, B3 and B2 launched on every rank
    for o in out:
        c = o["runs"]["dp-2rank"]["counts"]
        need(c["wave_partition_hist"] > 0 and c["wave_histogram"] > 0
             and c["score_update"] == ITERS
             and c["wave_partition_hist_deferred"] > 0
             and c["finish_hist"] > 0,
             "dp-2rank: rank %d launched %s" % (o["rank"], c))
    # the witness: a serial run on all the rows binned with rank 0's
    # mappers (each rank bins its block of features from a sample of its
    # own rows, the reference's distributed bin finding, so the bins are
    # not phase 4's)
    t1 = time.perf_counter()
    ref = TrainingData.from_binned(rank0)
    mine = data[0]._handle.bin_mappers
    moved = sum(not np.array_equal(a.bin_upper_bound, b.bin_upper_bound)
                for a, b in zip(ref.bin_mappers, mine))
    yt = np.asarray(data[0]._handle.metadata.label)
    ds_w = lgb.Dataset(data[2], label=yt, params=params)
    ds_w._handle = TrainingData.from_matrix(
        data[2], label=yt, config=Config(dict(params)), reference=ref)
    witness = lgb.train(params, ds_w, ITERS)
    w_auc = auc(yv, witness.predict(Xv))
    w_text = witness.model_to_string()
    del witness, ds_w, ref
    torch.cuda.empty_cache()
    dp = out[0]["runs"]["dp-2rank"]
    booster = lgb.Booster(model_str=dp["text"])
    dp_auc = auc(yv, booster.predict(Xv))
    del booster
    say("15b: rank 0's mappers bin %d of %d features otherwise than phase "
        "4's; the serial witness on them (all %d rows; %.1f s with "
        "binning) has valid AUC %.6f, phase 4's serial %.6f (|diff| %.2e)"
        % (moved, len(mine), len(yt), time.perf_counter() - t1, w_auc,
           AUCS["wave"], abs(w_auc - AUCS["wave"])))
    say("15b dp-2rank: AUC of rank 0's model on all %d valid rows %.6f, "
        "the witness's %.6f (|diff| %.2e, bound 2e-4), phase 4's %.6f "
        "(|diff| %.2e); the ranks' row-weighted valid AUC during training "
        "%.6f (printed, not compared: AUC does not decompose)"
        % (len(yv), dp_auc, w_auc, abs(dp_auc - w_auc), AUCS["wave"],
           abs(dp_auc - AUCS["wave"]), dp["reduced_valid"]["auc"]))
    need(abs(dp_auc - w_auc) <= 2e-4,
         "15b: data-parallel AUC %.6f not within 2e-4 of the serial run "
         "on the same bins (%.6f)" % (dp_auc, w_auc))
    compare_splits("dp-2rank", dp["text"], w_text)
    # 15c
    fp = out[0]["runs"]["feature-2rank"]["text"]
    need(fp == serial_exact, "15c: feature-parallel text differs from "
         "serial exact growth's")
    say("15c: feature-parallel model text equal to serial exact growth's "
        "to the byte (%d rows)" % small)
    same, n = compare_splits("voting-2rank",
                             out[0]["runs"]["voting-2rank"]["text"],
                             serial_exact)
    need(same == n == DIST_SMALL_ITERS, "15c: voting with top_k 28 does "
         "not match the serial tree structure")
    top5 = out[0]["runs"]["voting-top5-2rank"]
    b5 = lgb.Booster(model_str=top5["text"])
    auc5 = auc(ys, b5.predict(Xs))
    need(all(l == params["num_leaves"] for l in top5["leaves"]),
         "15c: voting top_k 5 grew %s leaves" % top5["leaves"])
    need(auc5 > 0.8, "15c: voting top_k 5 train AUC %.4f" % auc5)
    say("15c: voting top_k 5: a 255-leaf tree, train AUC %.6f on its %d "
        "rows" % (auc5, small))
    same, n = compare_splits("dp-exact-2rank",
                             out[0]["runs"]["dp-exact-2rank"]["text"],
                             serial_exact)
    need(same == n == DIST_SMALL_ITERS, "15c: data-parallel exact growth "
         "does not match the serial tree structure")
    shutil.rmtree(work, ignore_errors=True)
    say("phase 15 (distributed): %.1f s" % (time.perf_counter() - t0))
    return by_path


# ------------------------------------------------------------- phase 16
# 16a's rows (the first of phase 4's) and iterations, 16b's rows (the
# first of phase 5's Dataset) and iterations, 16c's requests: cuts in
# rows and requests that keep the phase within its 90 s
ELASTIC_ROWS = 200_000
ELASTIC_KILL_ITER = 2
DP_SPARSE_ROWS = 100_000
DP_SPARSE_ITERS = 3
SHARDED_REQUESTS = 2_000
SHARDED_DEVICES = ["cuda:0", "cuda:0"]


def phase16_elastic_rank(comm, payload):
    """A rank of 16a's elastic drill: parallel/worker.py train_worker
    (the kill hook, the checkpoints, the resume), every launch counter
    set to 0 just before and read just after."""
    from lightgbm_tpu_torch.parallel import worker
    zero_counts()
    out = worker.train_worker(comm, payload)
    out["counts"] = wrapper_counts()
    return out


def first_trees(lgb, text, n):
    """The model text of a text's first n trees (on the host)."""
    return lgb.Booster(model_str=text, device="cpu").model_to_string(
        num_iteration=n)


def tree_texts(text):
    """Each tree's lines of a model text, as one string a tree (without
    the feature importances that follow the last)."""
    body = text.split("\nfeature importances:")[0].split(
        "\nend of trees")[0]
    return ["Tree=" + t.rstrip("\n") for t in body.split("\nTree=")[1:]]


def elastic_dp_phase(lgb, card, sparse_data):
    """16a and 16b (see the module's docstring).  Returns the launches
    by path: the elastic run's last attempt (world 1), the uninterrupted
    2-rank run and the coordinate store's 2-rank run (rank 0's)."""
    import shutil
    import tempfile
    import torch
    from lightgbm_tpu_torch.parallel import worker
    from lightgbm_tpu_torch.parallel.elastic import run_elastic
    from lightgbm_tpu_torch.parallel.launch import run_ranks_subprocess
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="phase16_")
    # 16a's directory: the first rows of phase 4's recipe, binned alone
    params = dict(worker.default_params(), **flagship_params())
    params["tree_learner"] = "data"
    X, y = make_data(ELASTIC_ROWS)
    edir = os.path.join(work, "elastic")
    lgb.Dataset(X, label=y, params=params).construct()._handle.save_binned(
        edir)
    del X, y
    # 16b's directory: the first rows of phase 5's Dataset, its bins and
    # EFB groups as they are
    sds = sparse_data[0]
    sdir = os.path.join(work, "sparse")
    sds._handle.subset(np.arange(DP_SPARSE_ROWS)).save_binned(sdir)
    sp_params = dict(sparse_params(), tpu_sparse_kernel=False)
    say("16: directories %d x 28 and %d x %d groups written in %.1f s"
        % (ELASTIC_ROWS, DP_SPARSE_ROWS, sds._handle.num_features
           if sds._handle.bundle is None
           else len(sds._handle.bundle.groups), time.perf_counter() - t0))

    # the uninterrupted 2-rank run of 16a (its first trees) and 16b's
    # 2-rank run, in one launch of two rank processes
    t1 = time.perf_counter()
    runs = [{"label": "elastic-uninterrupted", "rows": ELASTIC_ROWS,
             "binned_dir": edir, "iters": ELASTIC_KILL_ITER,
             "params": params},
            {"label": "dp-sparse-2rank", "rows": DP_SPARSE_ROWS,
             "binned_dir": sdir, "iters": DP_SPARSE_ITERS,
             "params": dict(sp_params, tree_learner="data")}]
    out = run_ranks_subprocess(DIST_RANKS, "chip_smoke:phase15_rank",
                               {"runs": runs, "gen_rows": 1000},
                               timeout=300, device="cuda",
                               log_dir=os.path.join(work, "logs"))
    say("16: %d rank processes on %s over %s: %.1f s with start-up"
        % (len(out), ", ".join(o["device"] for o in out), out[0]["backend"],
           time.perf_counter() - t1))
    by_path = {}
    for run in runs:
        label = run["label"]
        rs = [o["runs"][label] for o in out]
        need(len({r["digest"] for r in rs}) == 1,
             "%s: the ranks' model texts differ" % label)
        need(all(r["trees"] == run["iters"] for r in rs),
             "%s: grew %s trees" % (label, [r["trees"] for r in rs]))
        by_path[label] = rs[0]["counts"]
        r0 = rs[0]
        say("%s (%s): texts byte-equal on %d ranks; rows a rank %s; "
            "leaves %s; steady %.4f it/s a rank (rank 0; %s); train %.2f s "
            "with set-up; all-reduce and the other collectives %d calls, "
            "%d bytes, %.3f s a rank, %.3f ms a pass; launches %s"
            % (label, r0["learner"], len(rs), [r["rows"] for r in rs],
               r0["leaves"], r0["steady_it_s"], card, r0["train_s"],
               r0["collective_calls"], r0["collective_bytes"],
               r0["collective_s"],
               1e3 * r0["collective_s"] / max(r0["passes_and_roots"], 1),
               {k: v for k, v in r0["counts"].items() if v}))
    unint = out[0]["runs"]["elastic-uninterrupted"]
    c = unint["counts"]
    need(c["wave_partition_hist_deferred"] > 0
         and c["wave_histogram_deferred"] > 0 and c["finish_hist"] > 0
         and c["score_update"] == ELASTIC_KILL_ITER,
         "elastic-uninterrupted: launched %s" % c)
    sp = out[0]["runs"]["dp-sparse-2rank"]
    need(sp["counts"]["score_update"] == DP_SPARSE_ITERS
         and sum(sp["counts"].values()) == DP_SPARSE_ITERS,
         "dp-sparse-2rank: launches %s (B2 once an iteration and nothing "
         "else)" % sp["counts"])

    # 16b: the serial coordinate store on the same directory
    t1 = time.perf_counter()
    serial = lgb.train(sp_params, lgb.Dataset.from_binned(sdir,
                                                          params=sp_params),
                       DP_SPARSE_ITERS)
    serial_text = serial.model_to_string()
    need(serial._gbdt.learner.hist_mode == "sparse",
         "16b: the serial run did not take the coordinate store")
    del serial
    torch.cuda.empty_cache()
    same, n = compare_splits("dp-sparse-2rank", sp["text"], serial_text)
    need(same == n == DP_SPARSE_ITERS, "16b: the data-parallel coordinate "
         "store does not split as the serial store")
    say("16b: serial coordinate store on the directory %.1f s; the "
        "2-rank text %s the serial text to the byte (the splits are "
        "required, the bytes printed)"
        % (time.perf_counter() - t1,
           "equals" if sp["text"] == serial_text else "differs from"))

    # 16a: the drill
    t1 = time.perf_counter()
    ck = os.path.join(work, "ck")
    obs = os.path.join(work, "tl.jsonl")
    payload = {"binned_dir": edir, "num_rounds": ITERS, "device": "cuda",
               "checkpoint_dir": ck, "checkpoint_every": 1,
               "kill_rank": 1, "kill_iter": ELASTIC_KILL_ITER,
               "return_model": True, "obs_path": obs, "params": params}
    el = run_elastic(DIST_RANKS, "chip_smoke:phase16_elastic_rank",
                     payload, device="cuda", timeout=300)
    el_s = time.perf_counter() - t1
    rec = el["flight_records"]
    need(el["attempts"] == 2 and el["world_size"] == 1,
         "16a: attempts %d, world %d" % (el["attempts"], el["world_size"]))
    need(len(rec) == 1 and 1 in rec[0]["failed_ranks"],
         "16a: flight records %s" % [r.get("failed_ranks") for r in rec])
    events = []
    for name in sorted(os.listdir(work)):
        if name.startswith("tl.jsonl"):
            with open(os.path.join(work, name)) as f:
                events += [json.loads(ln) for ln in f if ln.strip()]
    shrink = [e for e in events if e.get("ev") == "mesh_shrink"]
    need(len(shrink) == 1 and shrink[0]["world_size_from"] == 2
         and shrink[0]["world_size_to"] == 1
         and shrink[0]["it"] == ELASTIC_KILL_ITER,
         "16a: mesh_shrink events %s" % shrink)
    res = el["results"][0]
    text = res["model"]
    need(res["num_trees"] == ITERS and res["num_data"] == ELASTIC_ROWS,
         "16a: the resumed run has %d trees on %d rows"
         % (res["num_trees"], res["num_data"]))
    head = first_trees(lgb, text, ELASTIC_KILL_ITER)
    need(tree_texts(text)[:ELASTIC_KILL_ITER] == tree_texts(unint["text"]),
         "16a: the first %d trees differ from the uninterrupted 2-rank "
         "run's" % ELASTIC_KILL_ITER)
    t2 = time.perf_counter()
    # the continuation writes a checkpoint every round into the drill's
    # directory (an init_model run reads none), as the resumed world
    # does: a booster's drift fingerprint keeps the training scores of
    # the first text it writes, so both texts carry round 3's
    cont_params = dict(params, checkpoint_dir=ck, checkpoint_every=1)
    cont = lgb.train(cont_params,
                     lgb.Dataset.from_binned(edir, params=cont_params),
                     ITERS - ELASTIC_KILL_ITER,
                     init_model=lgb.Booster(model_str=head))
    cont_text = cont.model_to_string()
    need(cont_text == text, "16a: the resumed text differs from the "
         "serial init_model continuation's")
    del cont
    torch.cuda.empty_cache()
    by_path["elastic-world1"] = res["counts"]
    need(res["counts"]["wave_partition_hist"] > 0
         and res["counts"]["score_update"] == ITERS - ELASTIC_KILL_ITER,
         "16a: the resumed world launched %s" % res["counts"])
    say("16a on %s: run_elastic %.1f s (2 attempts, 2 then 1 rank, a "
        "flight record naming rank(s) %s with exit codes %s), mesh_shrink "
        "2 -> 1 at iteration %d; the first %d trees byte-equal to the "
        "uninterrupted 2-rank run's, the whole text to the serial "
        "init_model continuation's (%.1f s); the resumed world's "
        "launches %s"
        % (card, el_s, rec[0]["failed_ranks"], rec[0]["returncodes"],
           shrink[0]["it"], ELASTIC_KILL_ITER, time.perf_counter() - t2,
           {k: v for k, v in res["counts"].items() if v}))
    shutil.rmtree(work, ignore_errors=True)
    say("phase 16a-b (elastic, the coordinate store over two ranks): "
        "%.1f s" % (time.perf_counter() - t0))
    return by_path


def sharded_serve_phase(lgb, card, serve_data):
    """16c (see the module's docstring) on phase 7's model and rows."""
    import torch
    from lightgbm_tpu_torch.ops import predict as tp
    t0 = time.perf_counter()
    X, _, Xf, _, text = serve_data
    booster = lgb.Booster(model_str=text)
    gbdt = booster._gbdt
    gbdt._materialize()
    block = gbdt._TREE_BLOCK
    rp = tp.build_ranked_predictor(gbdt.models, 1, X.shape[1], "cuda")
    V, D = tp.rank_encode(rp, X)
    Vd = torch.as_tensor(V, device="cuda")
    Dd = torch.as_tensor(D, device="cuda")
    one = tp.ranked_predict(rp.dev, Vd, Dd, block)
    two, n = tp.ranked_predict_sharded(rp, Vd, Dd, 1,
                                       devices=SHARDED_DEVICES,
                                       tree_block=block)
    need(n == len(X) and torch.equal(two[:n], one),
         "16c: ranked_predict_sharded differs from ranked_predict")
    one_ms = time_ms(lambda: tp.ranked_predict(rp.dev, Vd, Dd, block),
                     reps=2, groups=3, warmup=1)
    two_ms = time_ms(lambda: tp.ranked_predict_sharded(
        rp, Vd, Dd, 1, devices=SHARDED_DEVICES, tree_block=block),
        reps=2, groups=3, warmup=1)
    del Vd, Dd, one, two
    raw1 = booster.predict(X, raw_score=True)
    booster.set_predict_devices(SHARDED_DEVICES)
    raw2 = booster.predict(X, raw_score=True)
    booster.set_predict_devices(None)
    need(np.array_equal(raw1, raw2), "16c: Booster.predict over two "
         "entries differs from one device")
    say("16c ranked_predict on %s: %d rows, 100 trees, one device %.3f ms, "
        "sharded over %s %.3f ms (a replica of the trees each); bit-equal, "
        "and Booster.predict through set_predict_devices too"
        % (card, n, one_ms, SHARDED_DEVICES, two_ms))
    ladder = [1 << b for b in range(6, 13)]           # 64 .. 4096
    got = {}
    for label, devices in (("one", None), ("two", SHARDED_DEVICES)):
        sp = booster.serve(max_batch=SERVE_MAX_BATCH, max_delay_ms=2.0,
                           devices=devices)
        try:
            sp.cache.warmup(ladder, convert=False)
            sp.warmup(ladder)
            lat, wall, rows, done = run_load(
                sp, Xf, SHARDED_REQUESTS, SERVE_THREADS, SERVE_SIZES,
                raw=True)
            st = sp.stats()["executables"]
            desc = sp.cache.describe()
        finally:
            sp.close()
        need(st["steady_state_compiles"] == 0,
             "16c %s: %d captures after warm-up"
             % (label, st["steady_state_compiles"]))
        got[label] = done
        say("16c serving on %s (%s): %d requests from %d threads, %d rows "
            "in %.3f s (%.0f rows/s), p50 %.3f ms, p99 %.3f ms; %d graphs "
            "on %s, no capture after warm-up"
            % (card, label, len(lat), SERVE_THREADS, rows, wall,
               rows / wall, 1e3 * np.percentile(lat, 50),
               1e3 * np.percentile(lat, 99), st["graphs"],
               desc["device_list"]))
    need(len(got["one"]) == len(got["two"]) and all(
        a[:2] == b[:2] and np.array_equal(a[2], b[2])
        for a, b in zip(got["one"], got["two"])),
        "16c: raw scores over two entries differ from one device's")
    say("16c: every response over the two entries bit-equal to one "
        "device's; phase 16c %.1f s" % (time.perf_counter() - t0))


def lint_phase(card):
    """16d: the static analyzer on the card's machine."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                          "lint", "--check"],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    need(run.returncode == 0, "16d: lint --check exited %d:\n%s%s"
         % (run.returncode, run.stdout[-4000:], run.stderr[-4000:]))
    say("16d: python -m lightgbm_tpu_torch lint --check: exit 0 (%s) in "
        "%.1f s on the card's machine (%s)"
        % (run.stdout.strip().splitlines()[-1], time.perf_counter() - t0,
           card))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="training rows (bench.py's flagship has 10,500,000)")
    ap.add_argument("--sparse-rows", type=int, default=500_000,
                    help="sparse training rows (Bosch has 1,000,000; half "
                         "of them by default, a cut in rows that keeps "
                         "the script in its time)")
    ap.add_argument("--profile", action="store_true",
                    help="after each training run's checks, profile one "
                         "more iteration")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 9's ranking data")
    ap.add_argument("--sweep", action="store_true",
                    help="also time B5 on B4's chain and B6 at 256, 512 "
                         "and 1024 threads a block")
    args = ap.parse_args()
    need(1000 <= args.rows <= 10_500_000, "--rows must be in [1000, 10.5M]")
    need(1000 <= args.sparse_rows <= 2_000_000,
         "--sparse-rows must be in [1000, 2M]")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on the GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops import leaf_hist as lh
    from lightgbm_tpu_torch.ops import predict as tp
    from lightgbm_tpu_torch.ops import sparse_mxu as sm
    from lightgbm_tpu_torch.ops import wave_kernels as wk
    from lightgbm_tpu_torch.ops.partition import clipped_leaf_values
    kernels = {"wave_partition_hist": wk.wave_partition_hist,
               "wave_histogram": wk.wave_histogram,
               "wave_histogram_rowmajor": wk.wave_histogram_rowmajor,
               "leaf_histogram": lh.leaf_histogram,
               "score_update": tp.score_update,
               "sparse_wave_histogram": sm.sparse_wave_histogram}

    # ---- 1. card and build
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say("card: %s" % card)
    say("torch %s, CUDA %s, %d device(s)" % (torch.__version__,
                                             torch.version.cuda,
                                             torch.cuda.device_count()))
    _build.library()
    say("build: %.1f s (nvcc, sm_90a)" % _build.build_seconds)
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            say("  " + ln.strip())
    dev = torch.device("cuda")

    # flagship data; binning is set-up (the datasets are constructed once
    # and serve all three dense runs)
    t0 = time.perf_counter()
    X, y = make_data(args.rows + VALID_ROWS)
    Xt_raw, yt = X[:args.rows], y[:args.rows]
    Xv, yv = X[args.rows:], y[args.rows:]
    params = flagship_params()
    ds = lgb.Dataset(Xt_raw, label=yt, params=params).construct()
    dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    td = ds._handle
    say("data: %d train rows, %d valid rows, %d features, %d bins max, "
        "bundles %s (%.1f s)" % (td.num_data, len(yv), td.num_features,
                                 int(td.num_bin_arr.max()),
                                 td.bundle is not None,
                                 time.perf_counter() - t0))
    need(td.bundle is None and td.num_features == 28
         and int(td.num_bin_arr.max()) <= 63, "unexpected flagship binning")
    data = (ds, dv, Xt_raw, Xv, yv)

    # ---- 2 + 3. kernels against plain, and their times
    t0 = time.perf_counter()
    X_t = torch.as_tensor(np.ascontiguousarray(td.binned.T), device=dev)
    records = kernel_phase(X_t, torch.as_tensor(td.default_bin_arr), wk, lh,
                           tp, clipped_leaf_values, args.sweep)
    # ---- 15a. the deferred-finish forms and the finish alone
    records.update(dist_kernel_phase(X_t, torch.as_tensor(td.default_bin_arr),
                                     wk, lh))
    del X_t
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("kernel checks and timing: %.1f s" % (time.perf_counter() - t0))

    # ---- 4. the main path: lightgbm_tpu_torch.train on the flagship
    # recipe, wave growth through B1 (and B3 for the root)
    booster, launches, stats = dense_train_phase("wave", params, data, lgb,
                                                 kernels, card, args)
    need(fused_of(booster) is not None,
         "the main path did not run fused (tpu_fused_iter=auto on CUDA)")
    check_wave_launches("wave", booster, launches, stats,
                        "wave_partition_hist")
    main_text = booster.model_to_string()
    del booster
    torch.cuda.empty_cache()
    booster, staged_launches, stats = staged_twin(
        "wave", params, main_text, data, lgb, kernels, card, args)
    check_wave_launches("wave-staged", booster, staged_launches, stats,
                        "wave_partition_hist")
    del booster
    torch.cuda.empty_cache()
    small_run_matches_cpu(lgb, [{"tpu_wave_width": 4},
                                {"tpu_wave_width": 14}])
    say("checks: device scores match host trees; model text round trip; "
        "small run on the card (fused) matches the CPU (staged)")

    # ---- 4a. the pallas_t dataflow (what the learner resolves to above
    # the ct bound): plain routing, then B3 for the root and each wave
    # (twice a wave without the histogram cache); the same fixed point as
    # the main path, so the same model text to the byte
    pallas_t = dict(params, tpu_histogram_mode="pallas_t")
    booster, pallas_t_launches, stats = dense_train_phase(
        "wave-pallas_t", pallas_t, data, lgb, kernels, card, args)
    need(fused_of(booster) is not None, "pallas_t: did not run fused")
    check_wave_launches("wave-pallas_t", booster, pallas_t_launches, stats,
                        "wave_histogram")
    need(booster.model_to_string() == main_text,
         "pallas_t: model text differs from the main path's (pallas_ct)")
    del booster
    torch.cuda.empty_cache()
    booster, launches_t, stats = staged_twin(
        "wave-pallas_t", pallas_t, main_text, data, lgb, kernels, card, args)
    check_wave_launches("wave-pallas_t-staged", booster, launches_t, stats,
                        "wave_histogram")
    say("wave-pallas_t checks: device scores match host trees; model text "
        "round trip; fused and staged model text equal to the main path's "
        "to the byte")
    del booster
    torch.cuda.empty_cache()

    # ---- 4b. exact (leaf-wise) growth: B5 for the root and the smaller
    # child of each gated split (both children without the histogram
    # cache).  Fused (auto on the card: a tree graph of S gated splits,
    # a read, tail graphs of S splits), again with S = L - 1 (one graph
    # a tree), then staged; the three model texts equal to the byte
    from lightgbm_tpu_torch.ops import fused_iter as fi
    exact_params = dict(params, tpu_growth="exact",
                        tpu_histogram_mode="pallas")
    booster, exact_launches, stats = dense_train_phase(
        "exact", exact_params, data, lgb, kernels, card, args)
    need(fused_of(booster) is not None,
         "exact growth did not run fused (tpu_fused_iter=auto on CUDA)")
    check_exact_launches("exact", booster, exact_launches, stats)
    exact_text = booster.model_to_string()
    del booster
    torch.cuda.empty_cache()
    block = fi.SPLIT_BLOCK
    fi.SPLIT_BLOCK = params["num_leaves"] - 1
    try:
        booster, launches_s, stats = dense_train_phase(
            "exact-S%d" % fi.SPLIT_BLOCK, exact_params, data, lgb, kernels,
            card, args)
    finally:
        fi.SPLIT_BLOCK = block
    check_exact_launches("exact-S%d" % (params["num_leaves"] - 1), booster,
                         launches_s, stats)
    need(booster.model_to_string() == exact_text,
         "exact: model text differs between S = %d and S = %d"
         % (block, params["num_leaves"] - 1))
    del booster
    torch.cuda.empty_cache()
    booster, launches_e, stats = staged_twin(
        "exact", exact_params, exact_text, data, lgb, kernels, card, args)
    check_exact_launches("exact-staged", booster, launches_e, stats)
    small_run_matches_cpu(lgb, [{"tpu_growth": "exact",
                                 "tpu_histogram_mode": "pallas"}])
    say("exact checks: device scores match host trees; model text round "
        "trip; fused (S = %d and S = %d) and staged model text equal to the "
        "byte; small exact run on the card matches the CPU"
        % (block, params["num_leaves"] - 1))
    del booster
    torch.cuda.empty_cache()

    # ---- 4c. wave growth on the row-major bins: B4 for the root and
    # each wave (twice a wave without the histogram cache)
    rowmajor = dict(params, tpu_histogram_mode="pallas")
    booster, rowmajor_launches, stats = dense_train_phase(
        "wave-pallas", rowmajor, data, lgb, kernels, card, args)
    need(fused_of(booster) is not None, "wave-pallas: did not run fused")
    check_wave_launches("wave-pallas", booster, rowmajor_launches, stats,
                        "wave_histogram_rowmajor")
    need(booster.model_to_string() == main_text,
         "wave-pallas: model text differs from the main path's (pallas_ct)")
    del booster
    torch.cuda.empty_cache()
    booster, launches_r, stats = staged_twin(
        "wave-pallas", rowmajor, main_text, data, lgb, kernels, card, args)
    check_wave_launches("wave-pallas-staged", booster, launches_r, stats,
                        "wave_histogram_rowmajor")
    small_run_matches_cpu(lgb, [{"tpu_histogram_mode": "pallas",
                                 "tpu_wave_width": 4}])
    say("wave-pallas checks: device scores match host trees; model text "
        "round trip; fused and staged model text equal to the main path's "
        "to the byte; small row-major run on the card matches the CPU")
    del booster
    torch.cuda.empty_cache()

    # ---- 4d. exact-order waves on the main path (tpu_wave_order=exact,
    # pallas_ct, W = 32): B1 once a wave pass, B3 for the root; a wave
    # commits the leaf-wise prefix of its candidates, so the model text
    # must be exact growth's (4b) to the byte, fused and staged
    order_params = dict(params, tpu_wave_order="exact")
    booster, order_launches, stats = dense_train_phase(
        "wave-exact-order", order_params, data, lgb, kernels, card, args)
    need(fused_of(booster) is not None, "exact order: did not run fused")
    check_wave_launches("wave-exact-order", booster, order_launches, stats,
                        "wave_partition_hist")
    need(booster.model_to_string() == exact_text,
         "exact-order waves: model text differs from exact growth's")
    say("wave-exact-order: %.2f waves a tree (M = %d), %.2f tail waves a "
        "tree; model text equal to exact growth's to the byte"
        % (sum(s.passes for s in stats) / len(stats), fused_of(booster).passes,
           sum(s.tail_passes for s in stats) / len(stats)))
    del booster
    torch.cuda.empty_cache()
    booster, launches_o, stats = staged_twin(
        "wave-exact-order", order_params, exact_text, data, lgb, kernels,
        card, args)
    check_wave_launches("wave-exact-order-staged", booster, launches_o,
                        stats, "wave_partition_hist")
    del booster
    torch.cuda.empty_cache()

    # ---- 15b, 15c. distributed training: two rank processes on the card
    # over gloo (dist_phase)
    dist_launches = dist_phase(args, lgb, card, data)

    # ---- 12a. out-of-core: phase 4's rows streamed to a binned
    # directory and trained fused through the paged upload
    streamed_launches = streamed_phase(args, lgb, kernels, card, data,
                                       main_text)

    # ---- 14c. the single-process observers on the main path (phase 4's
    # Dataset, fused), on and off; the watchdog and incident drills
    observer_launches = observers_phase(lgb, kernels, card, data,
                                        main_text)

    # ---- 11. the measured autotuner and the run observer on the
    # flagship's Dataset (autotune_phase)
    probe_launches = autotune_phase(args, lgb, kernels, card, data)

    # ---- 10. the kernels' packed and bf16 forms: their checks and
    # times, the max_bin = 15 flagship packed on the three dense
    # dataflows, bf16 on the main path, compaction's knob (forms_phase)
    form_records, form_paths, form_launches = forms_phase(
        args, lgb, kernels, card, data, main_text)
    records.update(form_records)

    # ---- 13. two-byte bins (max_bin 1023 through B3, B1, B4, B5), the
    # f64 form (tpu_use_dp), the XLA engines and the gather (wide_phase)
    wide_records, wide_paths, wide_forms = wide_phase(
        args, lgb, kernels, card, data, main_text)
    records.update(wide_records)
    form_paths.update(wide_paths)
    form_launches.update(wide_forms)

    # ---- 4e. DART, GOSS and InfiniteBoost on the flagship data: staged,
    # exact-order waves (auto), B3 for the root, B1 every wave, B2 once a
    # tree; then softmax over 7 classes on the flagship features, 35
    # trees, B2 into row tid of the (7, N) score
    mode_launches = boosting_modes_phase(lgb, kernels, card, data)
    mode_launches["multiclass"] = multiclass_phase(args, lgb, kernels, card,
                                                   ds, Xt_raw, Xv)
    say("rates on %s, whole-call / steady it/s: dart %.4f / %.4f, goss "
        "%.4f / %.4f, infiniteboost %.4f / %.4f, multiclass (7 trees an "
        "iteration) %.4f / %.4f"
        % ((card,) + RATES["dart"] + RATES["goss"] + RATES["infiniteboost"]
           + RATES["multiclass"]))
    # ---- 9c. custom objectives on the flagship data (phase 9's part that
    # needs phase 4's rows and model text)
    t9 = time.perf_counter()
    fobj_launches = fobj_phase(lgb, kernels, card, data, main_text)
    t9 = time.perf_counter() - t9
    del data, ds, dv
    torch.cuda.empty_cache()
    early_stopping_phase(lgb, card)
    small_run_matches_cpu(lgb, [
        {"objective": "multiclass", "num_class": 3},
        {"objective": "multiclassova", "num_class": 3},
        {"objective": "regression_l1"}, {"objective": "huber"},
        {"objective": "fair"}, {"objective": "poisson"},
        {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
        {"boosting": "infinite"}])
    say("small runs on the card (softmax, OVA, L1, Huber, Fair, Poisson, "
        "DART, InfiniteBoost) match the CPU")
    goss_matches_cpu(lgb)
    small_exact_order_runs(lgb)
    say("rates on %s, whole-call / steady it/s: main path fused %.4f / "
        "%.4f, staged %.4f / %.4f; exact growth fused %.4f / %.4f (S = %d), "
        "%.4f / %.4f (S = %d), staged %.4f / %.4f; exact-order waves fused "
        "%.4f / %.4f, staged %.4f / %.4f"
        % ((card,) + RATES["wave"] + RATES["wave-staged"] + RATES["exact"]
           + (block,) + RATES["exact-S%d" % (params["num_leaves"] - 1)]
           + (params["num_leaves"] - 1,) + RATES["exact-staged"]
           + RATES["wave-exact-order"] + RATES["wave-exact-order-staged"]))

    # ---- 5. the sparse path: B6 at the Bosch store, then training
    (records["sparse_wave_histogram"], sparse_launches,
     records["sparse_wave_histogram_bf16"],
     form_launches["sparse-bf16"], sparse_data) = sparse_phase(
         args, lgb, sm, kernels, card)

    # ---- 14a. the coordinate store on phase 5's Dataset; 14b. DART,
    # rollback and continued training on both sparse stores from raw rows
    coord_launches = coord_store_phase(lgb, kernels, card, sparse_data)
    # ---- 16a, 16b. the elastic drill and the coordinate store over two
    # ranks (elastic_dp_phase)
    t16 = time.perf_counter()
    p16_launches = elastic_dp_phase(lgb, card, sparse_data)
    t16 = time.perf_counter() - t16
    del sparse_data
    torch.cuda.empty_cache()
    raw_launches = raw_modes_phase(lgb, kernels, card)

    # ---- 7. prediction and serving at bench_serve.py's full shape
    serve_data = serve_phase(args, lgb, card, dev)
    # ---- 16c. sharded prediction and serving over two entries of the
    # card, on phase 7's model and rows
    t1 = time.perf_counter()
    sharded_serve_phase(lgb, card, serve_data)
    t16 += time.perf_counter() - t1

    # ---- 8. the file path: the CLI and the host library on phase 7's
    # data (and 12b, its files through the CLI in two rounds)
    file_launches = file_phase(lgb, kernels, card, serve_data)

    # ---- 12c. the C ABI library on phase 7's rows
    PHASE12["c-abi"] = abi_phase(lgb, kernels, card, serve_data)

    # ---- 9. the Python API on the card: the python-guide examples,
    # ranking at MSLR-WEB10K's shape, pickling, cv and the estimators
    t0 = time.perf_counter()
    guide_phase(card)
    rank_launches = ranking_phase(lgb, kernels, card, args.seed)
    api_launches = api_phase(lgb, kernels, card, serve_data)
    del serve_data
    say("phase 9 launches: ranking %s; fobj %s; pickling, cv and the "
        "classifier %s" % (rank_launches, fobj_launches, api_launches))
    say("phase 9 (the Python API): %.1f s, and 9c %.1f s after phase 4"
        % (time.perf_counter() - t0, t9))

    # ---- 16d. the static analyzer
    t1 = time.perf_counter()
    lint_phase(card)
    t16 += time.perf_counter() - t1
    say("phase 16 (elastic, the coordinate store over two ranks, sharded "
        "prediction and serving, lint): %.1f s" % t16)

    # ---- 6. result lines: each kernel's launches from its own path's run
    # ("launches": B1, B2 and B3 the main path's, B4 the row-major run's,
    # B5 exact growth's, B6 the sparse run's), and every counted run that
    # launched it, by path ("launches_by_path")
    say("B3 launches: %d on the main path, %d on the pallas_t run"
        % (launches["wave_histogram"], pallas_t_launches["wave_histogram"]))
    for label, got in mode_launches.items():
        say("%s launches: B1 %d, B3 %d, B2 %d" % (
            label, got["wave_partition_hist"], got["wave_histogram"],
            got["score_update"]))
    own = {"wave_partition_hist": launches, "score_update": launches,
           "wave_histogram": launches,
           "wave_histogram_rowmajor": rowmajor_launches,
           "leaf_histogram": exact_launches,
           "sparse_wave_histogram": sparse_launches}
    paths = ([("main", launches), ("pallas_t", pallas_t_launches),
              ("exact", exact_launches), ("rowmajor", rowmajor_launches)]
             + list(mode_launches.items())
             + [("sparse", sparse_launches), ("files", file_launches),
                ("fobj", fobj_launches), ("ranking", rank_launches),
                ("api", api_launches), ("autotune-probes", probe_launches),
                ("streamed", streamed_launches),
                ("observers", observer_launches), ("coord", coord_launches),
                ("dart-chunked-raw", raw_launches)]
             + list(PHASE12.items()) + list(dist_launches.items())
             + list(p16_launches.items()))
    sources = {"wave_partition_hist": ("lightgbm_tpu_torch/csrc/wave_fused.cu",
                                       "lightgbm_tpu/ops/pallas_wave.py:508"),
               "score_update": ("lightgbm_tpu_torch/csrc/score_update.cu",
                                "lightgbm_tpu/ops/predict.py:151"),
               "wave_histogram": ("lightgbm_tpu_torch/csrc/wave_fused.cu",
                                  "lightgbm_tpu/ops/pallas_wave.py:367"),
               "wave_histogram_rowmajor": (
                   "lightgbm_tpu_torch/csrc/wave_fused.cu",
                   "lightgbm_tpu/ops/pallas_wave.py:263"),
               "leaf_histogram": ("lightgbm_tpu_torch/csrc/leaf_hist.cu",
                                  "lightgbm_tpu/ops/pallas_hist.py:163"),
               "sparse_wave_histogram": (
                   "lightgbm_tpu_torch/csrc/sparse_hist.cu",
                   "lightgbm_tpu/ops/sparse_mxu.py:196")}
    paths += list(form_paths.items())
    # the packed, bf16, uint16 and f64 forms: each from its own path's run,
    # its launches that form's count
    form_own = {"wave_partition_hist_packed": "packed-pallas_ct",
                "wave_histogram_packed": "packed-pallas_t",
                "wave_histogram_rowmajor_packed": "packed-pallas",
                "wave_partition_hist_bf16": "bf16",
                "wave_histogram_bf16": "bf16-pallas_t",
                "wave_histogram_rowmajor_bf16": "bf16-pallas",
                "sparse_wave_histogram_bf16": "sparse-bf16",
                "wave_partition_hist_uint16": "wide-pallas_ct",
                "wave_histogram_uint16": "wide-auto",
                "wave_histogram_rowmajor_uint16": "wide-pallas",
                "leaf_histogram_uint16": "wide-exact",
                "wave_partition_hist_f64": "dp",
                "wave_histogram_f64": "dp",
                "wave_histogram_rowmajor_f64": "dp-pallas",
                "leaf_histogram_f64": "dp-exact"}
    out = []
    for name in list(sources) + list(form_own):
        base = next(k for k in sorted(sources, key=len, reverse=True)
                    if name.startswith(k))
        src, repl = sources[base]
        if base == "leaf_histogram" and "one-scan" not in records[name][
                "shape"]:
            src = sources["wave_histogram_rowmajor"][0]   # B4's chain
        r = records[name]
        if name in form_own:
            launches_of = form_launches[form_own[name]][name]
            by_path = {path: got[name]
                       for path, got in form_launches.items()
                       if got.get(name)}
        else:
            launches_of = own[name][name]
            by_path = {path: got[name] for path, got in paths
                       if got.get(name)}
        need(launches_of > 0, "%s did not launch on its path" % name)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches_of,
                    "launches_by_path": by_path,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "shape": r["shape"], "checked": True})
    # phase 13's wide rows beyond the forms' own records: B3 uint16 at K
    # = 32 (its launches the uint16 form's on wide-auto, the roots among
    # them) and B1 and B3 (K = 32) on byte bins at max_bin 255 (their
    # launches on 13g's fused runs)
    by_label = dict(paths)
    extra_own = {
        "wave_histogram_k32_uint16": form_launches["wide-auto"][
            "wave_histogram_uint16"],
        "wave_partition_hist_byte255": by_label["wide255-pallas_ct"][
            "wave_partition_hist"],
        "wave_histogram_k32_byte255": by_label["wide255-auto"][
            "wave_histogram"]}
    for name, launches_of in extra_own.items():
        base = next(k for k in sorted(sources, key=len, reverse=True)
                    if name.startswith(k))
        src, repl = sources[base]
        r = records[name]
        need(launches_of > 0, "%s did not launch on its path" % name)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches_of,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "shape": r["shape"], "checked": True})
    # the deferred-finish forms (15a's records) and the finish alone, with
    # their launches on the distributed paths (rank 0's counts)
    dist_own = {"wave_partition_hist_deferred": "dp-2rank",
                "wave_histogram_deferred": "dp-2rank",
                "finish_hist": "dp-2rank",
                "leaf_histogram_deferred": "dp-exact-2rank"}
    for name, path in dist_own.items():
        r = records[name]
        base = name.replace("_deferred", "")
        src, repl = sources.get(base, sources["wave_partition_hist"])
        launches_of = dist_launches[path][name]
        need(launches_of > 0, "%s did not launch on %s" % (name, path))
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches_of,
                    "launches_by_path": {p: got[name] for p, got
                                         in dist_launches.items()
                                         if got.get(name)},
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "shape": r["shape"], "checked": True})
    say("total: %.1f s" % (time.perf_counter() - t_start))
    say(card)
    say(json.dumps({"kernels": out}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
