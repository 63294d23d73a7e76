"""Two-round streaming ingest of the port (lightgbm_tpu_torch/io/streaming.py)
against its in-memory construction and the JAX package's streaming.

Streamed text, ``.npy``, ndarray and CSC sources must give the mappers
(``to_dict``), the EFB bundles and the bins of the port's in-memory path
and of ``lightgbm_tpu`` ``TrainingData.from_streamed``/``from_file`` with
two-round loading, byte for byte (the same ``Random`` sample, its rows in
ascending order), with 1 and 2 workers and chunk sizes that cut the rows
unevenly.  A file above ``io/dataset.py STREAM_BYTES`` (lowered here)
streams through ``Dataset(path)``, and ``use_two_round_loading`` through
the CLI trains the in-memory CLI run's model text.
"""
import os

import numpy as np
import pytest

import jax

import lightgbm_tpu_torch as lgbt
import lightgbm_tpu_torch.cli as tcli
from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.io.sparse import SparseColumns as JSparseColumns
from lightgbm_tpu.utils.config import Config as JConfig
from lightgbm_tpu_torch.io import dataset as tdataset
from lightgbm_tpu_torch.io import streaming
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.io.sparse import SparseColumns
from lightgbm_tpu_torch.utils.config import Config
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


def same_dataset(a, b):
    """Mappers, used features, EFB groups, bins and labels byte-equal
    (a and b may come from either package)."""
    assert a.num_data == b.num_data
    assert a.used_feature_idx == b.used_feature_idx
    assert ([None if m is None else m.to_dict() for m in a.bin_mappers]
            == [None if m is None else m.to_dict() for m in b.bin_mappers])
    assert (a.bundle is None) == (b.bundle is None)
    if a.bundle is not None:
        assert ([list(map(int, g)) for g in a.bundle.groups]
                == [list(map(int, g)) for g in b.bundle.groups])
    assert a.binned.dtype == b.binned.dtype
    np.testing.assert_array_equal(a.binned, b.binned)
    np.testing.assert_array_equal(np.asarray(a.metadata.label),
                                  np.asarray(b.metadata.label))


def write_rows(path, X, y, sep="\t", header=None):
    with open(path, "w") as fh:
        if header:
            fh.write(header + "\n")
        for i in range(len(y)):
            fh.write(sep.join([str(int(y[i]))]
                              + ["%.17g" % v for v in X[i]]) + "\n")


def efb_matrix(n, seed):
    """Dense columns plus mutually exclusive sparse ones, which EFB
    bundles."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 9))
    owner = rng.integers(0, 5, n)
    for j in range(4, 9):
        X[owner != j - 4, j] = 0.0
    y = (X[:, 0] + X[:, 1] + X[:, 5] > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def tsv_file(tmp_path_factory):
    X, y = efb_matrix(5000, 13)
    X[:, :4][np.random.default_rng(1).random((5000, 4)) > 0.9] = 0.0
    path = str(tmp_path_factory.mktemp("stream") / "data.tsv")
    write_rows(path, X, y)
    return path, X, y


def test_count_and_detect(tsv_file):
    path, _, y = tsv_file
    assert streaming.count_rows(path, skip_header=False) == len(y)
    assert streaming.stream_supported(path, has_header=False)


@pytest.mark.parametrize("efb", [False, True])
@pytest.mark.parametrize("chunk_rows", [0, 777])
def test_streamed_text_matches_in_memory_and_jax(tsv_file, efb, chunk_rows):
    path = tsv_file[0]
    base = {"max_bin": 63, "verbose": -1, "enable_bundle": efb}
    stream = dict(base, use_two_round_loading=True)
    if chunk_rows:
        stream["ooc_chunk_rows"] = chunk_rows
    mem = TrainingData.from_file(path, Config(dict(base)))
    got = TrainingData.from_file(path, Config(dict(stream)))
    jax_td = JTrainingData.from_file(path, JConfig(dict(stream)))
    assert (got.bundle is not None) == efb
    assert got.construct_stats["source"] == "stream:text"
    same_dataset(got, mem)
    same_dataset(got, jax_td)


def test_streamed_valid_alignment(tsv_file):
    path = tsv_file[0]
    cfg = Config({"max_bin": 63, "verbose": -1,
                  "use_two_round_loading": True})
    train = TrainingData.from_file(path, cfg)
    valid = TrainingData.from_file(path, cfg, reference=train)
    np.testing.assert_array_equal(valid.binned, train.binned)


def test_streamed_header_and_ignore(tmp_path):
    rng = np.random.default_rng(3)
    n = 2000
    X = rng.normal(size=(n, 4))
    y = (X[:, 0] > 0).astype(np.int64)
    path = str(tmp_path / "h.csv")
    write_rows(path, X, y, sep=",", header="target,a,b,junk,c")
    cfg = dict(max_bin=63, verbose=-1, header=True,
               label_column="name:target", ignore_column="name:junk",
               use_two_round_loading=True, ooc_chunk_rows=333)
    got = TrainingData.from_file(path, Config(dict(cfg)))
    jax_td = JTrainingData.from_file(path, JConfig(dict(cfg)))
    cfg.pop("use_two_round_loading")
    mem = TrainingData.from_file(path, Config(cfg))
    same_dataset(got, mem)
    same_dataset(got, jax_td)
    assert got.feature_names == mem.feature_names == ["a", "b", "c"]


def test_streamed_blank_lines(tmp_path):
    path = str(tmp_path / "blanks.csv")
    with open(path, "w") as fh:
        fh.write("1,0.5,1.5\n\n0,2.5,0.25\n   \n1,0.75,3.5\n\n")
    assert streaming.count_rows(path, skip_header=False) == 3
    cfg = {"max_bin": 15, "verbose": -1, "min_data_in_leaf": 1,
           "min_data_in_bin": 1}
    got = TrainingData.from_file(
        path, Config(dict(cfg, use_two_round_loading=True)))
    assert got.num_data == 3
    same_dataset(got, TrainingData.from_file(path, Config(dict(cfg))))
    # chunks of a few bytes put blank lines at the chunk edges
    chunks, rows = streaming.plan_text_chunks(path, False, chunk_bytes=4)
    assert rows == 3 and sum(c[1] for c in chunks) == 3


def test_streamed_missing_token_text(tmp_path):
    """'na' tokens take the streamed and in-memory loaders through the
    same missing-value handling."""
    rng = np.random.default_rng(29)
    n = 1500
    X = rng.normal(size=(n, 3))
    y = (X[:, 0] > 0).astype(np.int64)
    miss = rng.random((n, 3)) > 0.9
    path = str(tmp_path / "miss.csv")
    with open(path, "w") as fh:
        for i in range(n):
            cells = ["na" if miss[i, j] else "%.17g" % X[i, j]
                     for j in range(3)]
            fh.write("%d,%s\n" % (y[i], ",".join(cells)))
    cfg = {"max_bin": 31, "verbose": -1, "use_missing": True}
    stream = dict(cfg, use_two_round_loading=True, ooc_chunk_rows=256)
    got = TrainingData.from_file(path, Config(dict(stream)))
    same_dataset(got, TrainingData.from_file(path, Config(dict(cfg))))
    same_dataset(got, JTrainingData.from_file(path, JConfig(dict(stream))))


def test_sketch_merge_order_independent():
    """Shuffled chunk order and split/merged sketches reassemble the bytes
    of data[sample_idx]."""
    import random as pyrandom
    rng = np.random.default_rng(5)
    data = rng.normal(size=(1000, 5))
    idx = sorted(pyrandom.Random(1).sample(range(1000), 200))
    bounds = [0, 137, 400, 401, 999, 1000]
    chunks = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        sel = [i - s for i in idx if s <= i < e]
        chunks.append((s, data[s:e][sel]))
    sk_a, sk_b = streaming.SampleSketch(5), streaming.SampleSketch(5)
    for j in (3, 0, 4):
        sk_a.add_chunk(*chunks[j])
    for j in (1, 2):
        sk_b.add_chunk(*chunks[j])
    sk_a.merge(sk_b)
    np.testing.assert_array_equal(sk_a.sample_matrix(), data[idx])


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("source", ["ndarray", "npy"])
@pytest.mark.parametrize("efb", [False, True])
def test_streamed_matrix_parity(tmp_path, workers, source, efb):
    """ndarray and .npy sources, serial and through the fork pool, NaNs
    included: the port's in-memory bins and the JAX package's streamed
    ones."""
    X, y = efb_matrix(3000, 11)
    X[:, :4][np.random.default_rng(2).random((3000, 4)) > 0.95] = np.nan
    data = X
    if source == "npy":
        data = str(tmp_path / "x.npy")
        np.save(data, X)
    base = {"max_bin": 31, "verbose": -1, "enable_bundle": efb}
    cfg = dict(base, ooc_workers=workers)
    got = TrainingData.from_streamed(data, y, Config(dict(cfg)),
                                     chunk_rows=777)
    same_dataset(got, TrainingData.from_matrix(X, y, Config(dict(base))))
    same_dataset(got, JTrainingData.from_streamed(data, y, JConfig(dict(cfg)),
                                                  chunk_rows=777))
    st = got.construct_stats
    assert st["source"] == "stream:" + ("matrix" if source == "ndarray"
                                        else "npy")
    assert st["rows"] == 3000 and st["chunks"] == 4
    assert st["workers"] == workers
    assert set(st) >= {"sketch_s", "bin_s", "write_s", "construct_s",
                       "peak_rss_bytes", "rss_growth_bytes"}


@pytest.mark.parametrize("chunk_rows", [1, 3, 199, 200, 500])
def test_streamed_chunk_boundaries(chunk_rows):
    """1-row chunks, a chunk edge exactly at n, one chunk larger than
    the data."""
    rng = np.random.default_rng(17)
    X = rng.normal(size=(200, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    cfg = {"max_bin": 15, "verbose": -1, "min_data_in_bin": 1,
           "min_data_in_leaf": 1}
    got = TrainingData.from_streamed(X, y, Config(dict(cfg)),
                                     chunk_rows=chunk_rows)
    same_dataset(got, TrainingData.from_matrix(X, y, Config(dict(cfg))))
    assert got.construct_stats["chunks"] == -(-200 // chunk_rows)


@pytest.mark.parametrize("workers", [1, 2])
def test_streamed_sparse_parity(workers):
    """The CSC source densifies one chunk at a time: the port's from_csc
    bins and the JAX package's streamed ones."""
    rng = np.random.default_rng(23)
    n, f = 2500, 9
    dense = rng.normal(size=(n, f))
    dense[rng.random((n, f)) > 0.2] = 0.0
    colptr, indices, values = [0], [], []
    for j in range(f):
        rows = np.nonzero(dense[:, j])[0]
        indices.extend(rows.tolist())
        values.extend(dense[rows, j].tolist())
        colptr.append(len(indices))
    arrays = (np.asarray(colptr, dtype=np.int64),
              np.asarray(indices, dtype=np.int64),
              np.asarray(values, dtype=np.float64), n, f)
    y = (dense[:, 0] > 0).astype(np.float64)
    cfg = {"max_bin": 31, "verbose": -1, "ooc_workers": workers}
    got = TrainingData.from_streamed(SparseColumns(*arrays), y,
                                     Config(dict(cfg)), chunk_rows=611)
    same_dataset(got, TrainingData.from_csc(SparseColumns(*arrays), y,
                                            Config({"max_bin": 31,
                                                    "verbose": -1})))
    same_dataset(got, JTrainingData.from_streamed(
        JSparseColumns(*arrays), y, JConfig(dict(cfg)), chunk_rows=611))
    st = got.construct_stats
    assert st["source"] == "stream:sparse" and st["chunks"] == 5


def test_streamed_reference_copies_the_mappers():
    X, y = efb_matrix(1200, 4)
    cfg = Config({"max_bin": 31, "verbose": -1})
    train = TrainingData.from_streamed(X, y, cfg, chunk_rows=500)
    valid = TrainingData.from_streamed(X[:700], y[:700], cfg,
                                       reference=train, chunk_rows=300)
    assert valid.bin_mappers is train.bin_mappers
    np.testing.assert_array_equal(valid.binned, train.binned[:700])


def test_large_file_streams_through_dataset_path(tsv_file, monkeypatch):
    """A file over STREAM_BYTES streams through Dataset(path) (no
    option asked for it) and trains the in-memory Dataset's text."""
    path, X, y = tsv_file
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "tpu_wave_width": 4}
    mem = lgbt.Dataset(path, params=params).construct()
    assert mem._handle.construct_stats["source"] == "matrix"
    monkeypatch.setattr(tdataset, "STREAM_BYTES", os.path.getsize(path) - 1)
    big = lgbt.Dataset(path, params=params).construct()
    assert big._handle.construct_stats["source"] == "stream:text"
    assert big._handle.raw_data is None
    same_dataset(big._handle, mem._handle)
    a = lgbt.train(params, mem, 3, device="cpu").model_to_string()
    b = lgbt.train(params, big, 3, device="cpu").model_to_string()
    assert a == b


@pytest.mark.parametrize("how", ["use_two_round_loading=true",
                                 "size", "ooc_binned_dir"])
def test_cli_two_round_trains_in_memory_text(tsv_file, tmp_path, how,
                                            monkeypatch):
    """The CLI's streamed runs (asked for, over the size threshold, or
    persisted to a binned directory, which a second run then trains on)
    write the in-memory run's model text."""
    path = tsv_file[0]
    common = ["task=train", "data=" + path, "objective=binary",
              "num_trees=3", "num_leaves=15", "max_bin=63",
              "device_type=cpu", "verbose=-1", "tpu_wave_width=4"]
    mem_model = str(tmp_path / "mem.txt")
    tcli.main(common + ["output_model=" + mem_model])
    out = str(tmp_path / "stream.txt")
    extra = []
    if how == "size":
        monkeypatch.setattr(tdataset, "STREAM_BYTES",
                            os.path.getsize(path) - 1)
    elif how == "ooc_binned_dir":
        extra = ["ooc_binned_dir=" + str(tmp_path / "binned")]
    else:
        extra = [how]
    tcli.main(common + extra + ["output_model=" + out])
    text = open(mem_model).read()
    assert open(out).read() == text
    if how == "ooc_binned_dir":
        # the directory's header carries no fingerprint (streaming writes
        # none, as in the JAX package): the reopened run's text is the
        # in-memory one but for the drift_fingerprint= line
        again = str(tmp_path / "again.txt")
        tcli.main([a for a in common if not a.startswith("data=")]
                  + ["data=" + str(tmp_path / "binned"),
                     "output_model=" + again])
        reopened = open(again).read()
        assert "\ndrift_fingerprint=" in text
        assert "drift_fingerprint=" not in reopened
        assert reopened.splitlines() == [
            ln for ln in text.splitlines()
            if not ln.startswith("drift_fingerprint=")]


# ------------------------------------------------ the worker pool (_run_pool)
def _square_or_hang(task):
    """A pool task: its square, except task 2, which never returns."""
    import time
    if task == 2:
        time.sleep(3600)
    return task * task


def _square_or_raise(task):
    if task == 3:
        raise ValueError("task three")
    return task * task


def test_pool_results_in_task_order():
    """Forked workers, each over its own share of the tasks and its own
    pipe, give [fn(t) for t in tasks] in the tasks' order, as the serial
    run does."""
    tasks = list(range(11))
    want = [t * t for t in tasks]
    assert streaming._run_pool(3, _square_or_raise, tasks[:3], {}) == \
        want[:3]
    assert streaming._run_pool(1, _square_or_raise, [0, 1, 2], {}) == \
        want[:3]
    assert streaming._run_pool(4, lambda t: streaming._WSTATE["k"] * t,
                               tasks, {"k": 2}) == [2 * t for t in tasks]
    assert streaming._WSTATE == {}       # the parent's state untouched


def test_pool_names_a_stuck_task_and_kills_its_workers(monkeypatch):
    """A task that never returns ends the wait after POOL_TASK_SECONDS
    with a LightGBMError naming it, and every worker is killed -- also
    where the parent holds a lock in another thread at the fork and has
    a Python SIGTERM handler that does nothing (the state in which
    multiprocessing.Pool's terminate() waited forever on a worker)."""
    import multiprocessing
    import signal
    import threading
    import time
    monkeypatch.setattr(streaming, "POOL_TASK_SECONDS", 2.0)
    held, release = threading.Lock(), threading.Event()

    def hold():
        with held:
            release.wait(30)
    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        t0 = time.monotonic()
        with pytest.raises(streaming.LightGBMError, match="task 2 "):
            streaming._run_pool(2, _square_or_hang, [0, 1, 2, 3], {})
        assert time.monotonic() - t0 < 30
        assert not multiprocessing.active_children()
    finally:
        signal.signal(signal.SIGTERM, prev)
        release.set()
        holder.join()


def test_pool_raises_a_workers_exception():
    """An exception in a worker's task is raised in the parent, and the
    other workers are gone."""
    import multiprocessing
    with pytest.raises(ValueError, match="task three"):
        streaming._run_pool(2, _square_or_raise, list(range(6)), {})
    assert not multiprocessing.active_children()
