"""The pre-binned directory format in the port
(lightgbm_tpu_torch/io/binned_format.py), its paged upload
(ops/learner.py paged_device_matrix) and its compatibility with the JAX
package's directories.

A round trip trains the in-memory Dataset's model text on every dense
dataflow, through the paged upload (the bin matrix is never built on the
host); the reload is mmap-backed; metadata survives; corrupt, truncated
and wrong-revision directories fail loudly; streamed construction keeps
to its peak-RSS budget in a fresh process; a directory either package
writes opens in the other with the same shard bytes and mappers and
trains that package's own text; the paged upload builds the one-shot
upload's X, byte for byte, in both layouts.
"""
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.utils.config import Config as JConfig
from lightgbm_tpu_torch.io import binned_format as bf
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.ops.learner import paged_device_matrix
from lightgbm_tpu_torch.utils.config import Config
from lightgbm_tpu_torch.utils.log import LightGBMError
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 5, "verbose": -1, "tpu_growth": "wave",
          "tpu_wave_width": 4}
# the JAX package's oracle of the wave path on the CPU (ROADMAP)
JAX_PARAMS = dict(PARAMS, tpu_histogram_mode="pallas_ct",
                  tpu_pallas_interpret=True, tpu_hist_precision="hilo")


@pytest.fixture(scope="module")
def xy():
    rng = np.random.default_rng(31)
    X = rng.normal(size=(3000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


def binned_dir(xy, tmp_path, name="binned", chunk_rows=None, **more):
    X, y = xy
    out = str(tmp_path / name)
    TrainingData.from_streamed(X, y, Config(dict(PARAMS)), out_dir=out,
                               chunk_rows=chunk_rows, **more)
    return out


def shard_bytes(path):
    with open(os.path.join(path, bf.HEADER_NAME)) as f:
        header = json.load(f)
    out = b""
    for s in header["shards"]:
        with open(os.path.join(path, s["file"]), "rb") as f:
            out += f.read()
    return header, out


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas_t", "pallas"])
def test_round_trip_trains_the_same_text_through_the_paged_upload(
        xy, tmp_path, mode):
    X, y = xy
    params = dict(PARAMS, tpu_histogram_mode=mode)
    want = lgbt.train(params, lgbt.Dataset(X, label=y, params=params), 5,
                      device="cpu").model_to_string()
    out = str(tmp_path / "rt")
    lgbt.Dataset(X, label=y, params=params).save_binned(out)
    for train_set in (lgbt.Dataset(out, params=params),
                      lgbt.Dataset.from_binned(out, params=params), out):
        bst = lgbt.train(params, train_set, 5, device="cpu")
        assert bst.model_to_string() == want
        learner = bst._gbdt.learner
        assert learner.upload_stats["paged"]
        assert learner.upload_stats["bytes"] == X.shape[0] * X.shape[1]
        # the host bin matrix was never built
        assert bst._gbdt.train_data._binned is None


def test_reload_is_mmap_backed_and_bins_nothing(xy, tmp_path):
    X, y = xy
    out = binned_dir(xy, tmp_path, chunk_rows=1000)
    td = TrainingData.from_binned(out)
    assert isinstance(td._binned_reader.shard(0), np.memmap)
    assert td._binned is None
    st = td.construct_stats
    assert st["source"] == "binned" and st["chunks"] == 3
    assert st["sketch_s"] == 0.0 and st["bin_s"] == 0.0
    ref = TrainingData.from_matrix(X, y, Config(dict(PARAMS)))
    np.testing.assert_array_equal(td.binned, ref.binned)
    np.testing.assert_array_equal(np.asarray(td.metadata.label),
                                  np.asarray(ref.metadata.label))
    assert ([m.to_dict() for m in td.bin_mappers]
            == [m.to_dict() for m in ref.bin_mappers])


def test_metadata_round_trip(xy, tmp_path):
    X, y = xy
    rng = np.random.default_rng(7)
    w = rng.random(len(y))
    init = rng.normal(size=len(y))
    group = [1000, 1200, 800]
    out = binned_dir(xy, tmp_path, name="meta", weights=w, group=group,
                     init_score=init)
    td = TrainingData.from_binned(out)
    np.testing.assert_allclose(np.asarray(td.metadata.weights), w, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(td.metadata.query_boundaries),
                                  np.cumsum([0] + group))
    np.testing.assert_array_equal(np.asarray(td.metadata.init_score), init)
    assert td.metadata.query_weights is not None
    # a Dataset's own metadata saves too
    out2 = str(tmp_path / "meta2")
    lgbt.Dataset(X, label=y, weight=w, params=PARAMS).save_binned(out2)
    td2 = TrainingData.from_binned(out2)
    np.testing.assert_allclose(np.asarray(td2.metadata.weights), w,
                               rtol=1e-6)


def test_row_range_opens_only_its_rows(xy, tmp_path):
    out = binned_dir(xy, tmp_path, chunk_rows=700)
    full = TrainingData.from_binned(out)
    part = TrainingData.from_binned(out, row_range=(800, 2000))
    assert part.num_data == 1200
    np.testing.assert_array_equal(part.binned, full.binned[800:2000])
    np.testing.assert_array_equal(part.metadata.label,
                                  full.metadata.label[800:2000])
    assert part._binned_reader.mapped_shards == {1, 2}
    assert part.construct_stats["row_range"] == [800, 2000]


def test_comm_with_several_ranks_is_refused(xy, tmp_path):
    """Once refused (distributed training), a comm of several ranks now
    opens each rank's share, rows [r * n // size, (r + 1) * n // size),
    as the JAX package's rank-sharded open does, and keeps the comm."""
    out = binned_dir(xy, tmp_path)
    X, _ = xy

    class Comm:
        size = 2

        def __init__(self, rank):
            self.rank = rank

    full = TrainingData.from_binned(out)
    parts = [TrainingData.from_binned(out, comm=Comm(r)) for r in (0, 1)]
    n = len(X)
    assert [p._binned_reader.row_range for p in parts] == [
        (0, n // 2), (n // 2, n)]
    np.testing.assert_array_equal(
        np.concatenate([p.binned for p in parts]), full.binned)
    np.testing.assert_array_equal(
        np.concatenate([p.metadata.label for p in parts]),
        full.metadata.label)
    assert all(p._comm is not None for p in parts)
    assert parts[1].construct_stats["world_size"] == 2


def test_corrupt_shard_fails_loudly(xy, tmp_path):
    out = binned_dir(xy, tmp_path)
    shard = os.path.join(out, bf.shard_name(0))
    with open(shard, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(bf.BinnedFormatError, match="checksum"):
        TrainingData.from_binned(out)
    # a lazy open checks the shard when it is first mapped
    td = TrainingData.from_binned(out, verify="lazy")
    with pytest.raises(bf.BinnedFormatError, match="checksum"):
        td.binned


def test_truncated_shard_fails_loudly(xy, tmp_path):
    out = binned_dir(xy, tmp_path)
    shard = os.path.join(out, bf.shard_name(0))
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) - 64)
    with pytest.raises(bf.BinnedFormatError, match="truncated"):
        TrainingData.from_binned(out, verify=False)      # size check alone


@pytest.mark.parametrize("field,value,match", [
    ("schema_rev", bf.SCHEMA_REV + 1, "schema rev"),
    ("schema_rev", 0, "schema rev"),
    ("magic", "something.else", "magic"),
    ("num_data", 1, "sums to"),
])
def test_bad_header_fails_loudly(xy, tmp_path, field, value, match):
    out = binned_dir(xy, tmp_path)
    hp = os.path.join(out, bf.HEADER_NAME)
    with open(hp) as f:
        header = json.load(f)
    header[field] = value
    with open(hp, "w") as f:
        json.dump(header, f)
    with pytest.raises(bf.BinnedFormatError, match=match):
        TrainingData.from_binned(out)


def test_missing_shard_and_sidecar_fail_loudly(xy, tmp_path):
    out = binned_dir(xy, tmp_path)
    os.remove(os.path.join(out, "label.npy"))
    with pytest.raises(bf.BinnedFormatError, match="missing"):
        TrainingData.from_binned(out)
    os.remove(os.path.join(out, bf.shard_name(0)))
    with pytest.raises(bf.BinnedFormatError, match="missing shard"):
        TrainingData.from_binned(out)


def test_can_load_binned_rejects_non_dirs(tmp_path):
    assert not TrainingData.can_load_binned(str(tmp_path / "absent"))
    assert not TrainingData.can_load_binned(str(tmp_path))   # no header
    plain = tmp_path / "plain.txt"
    plain.write_text("1,2,3\n")
    assert not TrainingData.can_load_binned(str(plain))


def test_shard_crc_matches_recompute(xy, tmp_path):
    out = binned_dir(xy, tmp_path, chunk_rows=1100)
    header, _ = shard_bytes(out)
    assert len(header["shards"]) == 3
    for sh in header["shards"]:
        with open(os.path.join(out, sh["file"]), "rb") as f:
            assert (zlib.crc32(f.read()) & 0xFFFFFFFF) == sh["crc32"]


def test_save_binned_of_a_reader_backed_dataset(xy, tmp_path):
    out = binned_dir(xy, tmp_path, chunk_rows=1000)
    td = TrainingData.from_binned(out)
    td.save_binned(out)                  # its own directory: no rewrite
    copy = str(tmp_path / "copy")
    td.save_binned(copy)
    assert td._binned is None            # copied shard by shard
    h1, b1 = shard_bytes(out)
    h2, b2 = shard_bytes(copy)
    assert b1 == b2 and h1["bin_mappers"] == h2["bin_mappers"]


def test_streamed_npy_rss_watermark(tmp_path):
    """The out-of-core contract, measured: a 64 MiB .npy streams into a
    binned directory in a fresh process with a peak-RSS growth of at most
    32 MiB (materializing the float64 matrix alone adds 64 MiB)."""
    n, f = 500_000, 16
    path = str(tmp_path / "big.npy")
    arr = np.lib.format.open_memmap(path, mode="w+", dtype=np.float64,
                                    shape=(n, f))
    rng = np.random.default_rng(3)
    for s in range(0, n, 50_000):
        arr[s:s + 50_000] = rng.normal(size=(50_000, f))
    del arr
    script = r"""
import resource
import sys

import numpy as np

sys.path.insert(0, sys.argv[3])
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.utils.config import Config

path, out = sys.argv[1], sys.argv[2]
cfg = {"max_bin": 63, "verbose": -1, "bin_construct_sample_cnt": 50000,
       "ooc_chunk_rows": 32768, "ooc_workers": 2}
# warm lazy allocations on a tiny build, so the reading below measures
# only the streamed construction
TrainingData.from_streamed(np.zeros((64, 4)), np.zeros(64),
                           Config(dict(cfg)))
scale = 1 if sys.platform == "darwin" else 1024
rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
td = TrainingData.from_streamed(path, np.zeros(500_000),
                                Config(dict(cfg)), out_dir=out)
rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
assert td._binned_reader is not None and td._binned is None
growth = rss1 - rss0
print("rss growth bytes:", growth)
assert growth <= 32 << 20, \
    "peak RSS grew %.1f MiB > 32 MiB budget" % (growth / 2**20)
assert td.construct_stats["rows"] == 500_000
"""
    r = subprocess.run(
        [sys.executable, "-c", script, path, str(tmp_path / "out"), REPO],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, \
        "watermark subprocess failed:\n%s\n%s" % (r.stdout, r.stderr)


def test_jax_written_directory_opens_in_the_port(xy, tmp_path):
    """Same shard bytes and mappers as the port's own directory, and the
    port trains its own text on it."""
    X, y = xy
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    JTrainingData.from_streamed(X, y, JConfig(dict(JAX_PARAMS)),
                                out_dir=jout, chunk_rows=1000)
    TrainingData.from_streamed(X, y, Config(dict(PARAMS)), out_dir=tout,
                               chunk_rows=1000)
    hj, bj = shard_bytes(jout)
    ht, bt = shard_bytes(tout)
    assert bj == bt
    assert hj["bin_mappers"] == ht["bin_mappers"]
    assert hj["magic"] == ht["magic"] and hj["shards"] == ht["shards"]
    td = TrainingData.from_binned(jout)
    np.testing.assert_array_equal(
        td.binned, TrainingData.from_binned(tout).binned)
    a = lgbt.train(PARAMS, jout, 5, device="cpu").model_to_string()
    b = lgbt.train(PARAMS, tout, 5, device="cpu").model_to_string()
    assert a == b


def test_port_written_directory_opens_in_the_jax_package(xy, tmp_path):
    """The JAX package trains its own text on the port's directory: both
    packages' headers carry the dataset's drift fingerprint (the same
    profile), which the model text repeats as a ``drift_fingerprint=``
    line."""
    X, y = xy
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    lgbt.Dataset(X, label=y, params=PARAMS).save_binned(tout)
    jlgb.Dataset(X, label=y, params=JAX_PARAMS).save_binned(jout)
    assert shard_bytes(tout)[1] == shard_bytes(jout)[1]
    jtd = JTrainingData.from_binned(tout)
    assert jtd._binned is None
    assert ([m.to_dict() for m in jtd.bin_mappers]
            == [m.to_dict() for m in TrainingData.from_binned(
                tout).bin_mappers])
    a = jlgb.train(JAX_PARAMS, tout, 3).model_to_string()
    b = jlgb.train(JAX_PARAMS, jout, 3).model_to_string()
    assert "\ndrift_fingerprint=" in a
    assert a == b


@pytest.mark.parametrize("row_major", [False, True])
@pytest.mark.parametrize("row_range", [None, (500, 2600)])
def test_paged_upload_builds_the_one_shot_matrix(xy, tmp_path, row_major,
                                                  row_range):
    """Shards of uneven size (1100 rows, last 800), whole or a row range:
    the paged X equals the one-shot upload of binned (or binned.T)."""
    out = binned_dir(xy, tmp_path, chunk_rows=1100)
    td = TrainingData.from_binned(out, row_range=row_range)
    X, stats = paged_device_matrix(td, row_major, torch.device("cpu"))
    assert td._binned is None
    host = td.binned
    want = host if row_major else host.T
    assert X.shape == want.shape and X.dtype == torch.uint8
    np.testing.assert_array_equal(X.numpy(), want)
    assert stats["bytes"] == host.size
    assert stats["staging_bytes"] == 1100 * host.shape[1]
    # a dataset without a reader uploads in one go
    assert paged_device_matrix(TrainingData.from_matrix(
        *xy, Config(dict(PARAMS))), row_major, "cpu") == (None, None)
