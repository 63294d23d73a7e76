"""Feature discretization (BinMapper) — host-side, numpy.

Parity target: src/io/bin.cpp:66-294.  Semantics kept exactly:

* ``greedy_find_bin`` — distinct-value greedy packing with ``min_data_in_bin``
  and big-count bins (bin.cpp:66-137).
* Zero-range handling: values in (-1e-20, 1e-20] get a dedicated "zero" bin;
  numeric bounds are found separately left/right of that range
  (bin.cpp:178-228); ``default_bin = value_to_bin(0)``.
* Categorical: count-sorted category list cut at 98% mass (bin.cpp:241-273),
  unseen categories map to the last bin (bin.h:433-440).
* Trivial-feature filtering via ``need_filter`` (bin.cpp:47-66).

Numerical features bin through the host library (``native.py``,
``csrc/host/native.cpp``) when it is built; the Python code here is its
fallback and gives the same bounds.  The binned representation feeds the
learner as a dense uint8/int32 matrix.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.common import kMissingValueRange
from ..utils.log import Log

NUMERICAL = 0
CATEGORICAL = 1

_BIN_TYPE_NAMES = {NUMERICAL: "numerical", CATEGORICAL: "categorical"}


def need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                bin_type: int) -> bool:
    """True when no split point leaves >= filter_cnt data on both sides
    (bin.cpp:47-66)."""
    n = len(cnt_in_bin)
    if bin_type == NUMERICAL:
        sum_left = 0
        for i in range(n - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
    else:
        for i in range(n - 1):
            sum_left = cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
    return True


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    num_distinct_values: int, max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Upper-bound list for one contiguous value region (bin.cpp:66-137)."""
    bin_upper_bound: List[float] = []
    if num_distinct_values <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct_values - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                bin_upper_bound.append(
                    (float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
                cur_cnt_inbin = 0
        bin_upper_bound.append(np.inf)
    else:
        if min_data_in_bin > 0:
            max_bin = min(max_bin, total_cnt // min_data_in_bin)
            max_bin = max(max_bin, 1)
        mean_bin_size = total_cnt / max_bin

        rest_bin_cnt = max_bin
        rest_sample_cnt = total_cnt
        is_big_count_value = [False] * num_distinct_values
        for i in range(num_distinct_values):
            if counts[i] >= mean_bin_size:
                is_big_count_value[i] = True
                rest_bin_cnt -= 1
                rest_sample_cnt -= int(counts[i])
        mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        upper_bounds = [np.inf] * max_bin
        lower_bounds = [np.inf] * max_bin

        bin_cnt = 0
        lower_bounds[bin_cnt] = float(distinct_values[0])
        cur_cnt_inbin = 0
        # np.float32 cast mirrors the C++ `0.5f` literal in the half-bin test
        half = float(np.float32(0.5))
        for i in range(num_distinct_values - 1):
            if not is_big_count_value[i]:
                rest_sample_cnt -= int(counts[i])
            cur_cnt_inbin += int(counts[i])
            if (is_big_count_value[i] or cur_cnt_inbin >= mean_bin_size or
                    (is_big_count_value[i + 1] and
                     cur_cnt_inbin >= max(1.0, mean_bin_size * half))):
                upper_bounds[bin_cnt] = float(distinct_values[i])
                bin_cnt += 1
                lower_bounds[bin_cnt] = float(distinct_values[i + 1])
                if bin_cnt >= max_bin - 1:
                    break
                cur_cnt_inbin = 0
                if not is_big_count_value[i]:
                    rest_bin_cnt -= 1
                    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        bin_cnt += 1
        bin_upper_bound = [0.0] * bin_cnt
        for i in range(bin_cnt - 1):
            bin_upper_bound[i] = (upper_bounds[i] + lower_bounds[i + 1]) / 2.0
        bin_upper_bound[bin_cnt - 1] = np.inf
    return bin_upper_bound


class BinMapper:
    """Per-feature value->bin mapping (include/LightGBM/bin.h:55-200)."""

    def __init__(self):
        self.num_bin: int = 1
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_type: int = NUMERICAL
        self.bin_upper_bound: Optional[np.ndarray] = None
        self.bin_2_categorical: Optional[np.ndarray] = None
        self.categorical_2_bin: Optional[dict] = None
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    # ------------------------------------------------------------------ find
    def find_bin(self, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 bin_type: int = NUMERICAL) -> None:
        """Build the mapping from sampled non-zero values (bin.cpp:139-294).

        ``sample_values`` excludes zeros; ``total_sample_cnt - len(values)``
        are implicit zeros, exactly like the reference's sampled columns.
        """
        self.bin_type = bin_type
        self.default_bin = 0
        values = np.asarray(sample_values, dtype=np.float64)
        # NaNs: this reference line treats only the zero-range as missing and
        # its parser never produces NaN; map them to zero for robustness.
        values = values[~np.isnan(values)]

        if bin_type == NUMERICAL:
            from .. import native
            res = native.find_bin_numerical(values, total_sample_cnt,
                                            max_bin, min_data_in_bin,
                                            min_split_data)
            if res is not None:
                (self.bin_upper_bound, self.is_trivial, self.min_val,
                 self.max_val, self.default_bin, self.sparse_rate) = res
                self.num_bin = len(self.bin_upper_bound)
                return
        # the pure-Python path: categorical features, and numerical ones
        # without the host library
        num_sample_values = len(values)
        zero_cnt = int(total_sample_cnt - num_sample_values)
        values = np.sort(values, kind="stable")

        # distinct values with zero spliced into sorted position
        distinct_values: List[float] = []
        counts: List[int] = []
        if num_sample_values == 0 or (values[0] > 0.0 and zero_cnt > 0):
            distinct_values.append(0.0)
            counts.append(zero_cnt)
        if num_sample_values > 0:
            distinct_values.append(float(values[0]))
            counts.append(1)
        for i in range(1, num_sample_values):
            if values[i] != values[i - 1]:
                if values[i - 1] < 0.0 and values[i] > 0.0:
                    distinct_values.append(0.0)
                    counts.append(zero_cnt)
                distinct_values.append(float(values[i]))
                counts.append(1)
            else:
                counts[-1] += 1
        if num_sample_values > 0 and values[num_sample_values - 1] < 0.0 and zero_cnt > 0:
            distinct_values.append(0.0)
            counts.append(zero_cnt)

        self.min_val = distinct_values[0]
        self.max_val = distinct_values[-1]
        num_distinct = len(distinct_values)
        dv = np.asarray(distinct_values)
        cv = np.asarray(counts)

        if bin_type == NUMERICAL:
            cnt_in_bin = self._find_bin_numerical(
                dv, cv, num_distinct, total_sample_cnt, max_bin, min_data_in_bin)
        else:
            cnt_in_bin = self._find_bin_categorical(
                dv, cv, total_sample_cnt, max_bin)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
        self.sparse_rate = float(cnt_in_bin[self.default_bin]) / total_sample_cnt \
            if len(cnt_in_bin) > self.default_bin else 0.0

    def _find_bin_numerical(self, dv, cv, num_distinct, total_sample_cnt,
                            max_bin, min_data_in_bin):
        # partition distinct values into (-inf,-1e-20], zero range, (1e-20,inf)
        left_mask = dv <= -kMissingValueRange
        right_mask = dv > kMissingValueRange
        mid_mask = ~left_mask & ~right_mask
        left_cnt_data = int(cv[left_mask].sum())
        missing_cnt_data = int(cv[mid_mask].sum())
        right_cnt_data = int(cv[right_mask].sum())

        left_cnt = 0
        for i in range(num_distinct):
            if dv[i] > -kMissingValueRange:
                left_cnt = i
                break
        bounds: List[float] = []
        if left_cnt > 0:
            denom = total_sample_cnt - missing_cnt_data
            left_max_bin = int(left_cnt_data / max(denom, 1) * (max_bin - 1))
            bounds = greedy_find_bin(dv[:left_cnt], cv[:left_cnt], left_cnt,
                                     left_max_bin, left_cnt_data, min_data_in_bin)
            bounds[-1] = -kMissingValueRange

        right_start = -1
        for i in range(left_cnt, num_distinct):
            if dv[i] > kMissingValueRange:
                right_start = i
                break
        if right_start >= 0:
            right_max_bin = max_bin - 1 - len(bounds)
            right_bounds = greedy_find_bin(
                dv[right_start:], cv[right_start:], num_distinct - right_start,
                right_max_bin, right_cnt_data, min_data_in_bin)
            bounds.append(kMissingValueRange)
            bounds.extend(right_bounds)
        else:
            bounds.append(np.inf)

        self.num_bin = len(bounds)
        self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        cnt_in_bin = np.zeros(self.num_bin, dtype=np.int64)
        i_bin = 0
        for i in range(num_distinct):
            if dv[i] > bounds[i_bin]:
                i_bin += 1
            cnt_in_bin[i_bin] += cv[i]
        if self.num_bin > max_bin:
            Log.fatal("Bin finding produced %d bins > max_bin %d", self.num_bin, max_bin)
        return cnt_in_bin

    def _find_bin_categorical(self, dv, cv, total_sample_cnt, max_bin):
        # merge into int categories (bin.cpp:241-252)
        cats: List[int] = [int(dv[0])]
        ccnt: List[int] = [int(cv[0])]
        for i in range(1, len(dv)):
            c = int(dv[i])
            if c != cats[-1]:
                cats.append(c)
                ccnt.append(int(cv[i]))
            else:
                ccnt[-1] += int(cv[i])
        # sort by count desc (stable, as Common::SortForPair)
        order = np.argsort(-np.asarray(ccnt), kind="stable")
        cats = [cats[i] for i in order]
        ccnt = [ccnt[i] for i in order]

        cut_cnt = int(total_sample_cnt * np.float32(0.98))
        max_bin = min(len(cats), max_bin)
        self.bin_2_categorical = []
        self.categorical_2_bin = {}
        self.num_bin = 0
        used_cnt = 0
        while used_cnt < cut_cnt or self.num_bin < max_bin:
            if self.num_bin >= len(cats):
                break
            self.bin_2_categorical.append(cats[self.num_bin])
            self.categorical_2_bin[cats[self.num_bin]] = self.num_bin
            used_cnt += ccnt[self.num_bin]
            self.num_bin += 1
        cnt_in_bin = ccnt[:self.num_bin]
        cnt_in_bin[-1] += total_sample_cnt - used_cnt
        self.bin_2_categorical = np.asarray(self.bin_2_categorical, dtype=np.int64)
        return np.asarray(cnt_in_bin, dtype=np.int64)

    # ---------------------------------------------------------------- lookup
    def value_to_bin(self, value):
        """Scalar or vectorized value->bin (bin.h:419-441)."""
        if self.bin_type == NUMERICAL:
            v = np.asarray(value, dtype=np.float64)
            idx = np.searchsorted(self.bin_upper_bound, v, side="left")
            # NaN / overflow land in last bin (C++ binary search behavior)
            idx = np.minimum(idx, self.num_bin - 1)
            return idx if idx.shape else int(idx)
        else:
            if np.isscalar(value) or np.asarray(value).ndim == 0:
                return self.categorical_2_bin.get(int(value), self.num_bin - 1)
            v = np.asarray(value)
            out = np.empty(v.shape, dtype=np.int64)
            flat_v = v.reshape(-1)
            flat_o = out.reshape(-1)
            for i in range(flat_v.size):
                x = flat_v[i]
                key = 0 if np.isnan(x) else int(x)
                flat_o[i] = self.categorical_2_bin.get(key, self.num_bin - 1)
            return out

    def bin_to_value(self, bin_idx: int) -> float:
        """bin -> representative real value (bin.h:98-104): numerical uses the
        bin's upper bound, categorical the category value."""
        if self.bin_type == NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    # ------------------------------------------------------------------ info
    def bin_info(self) -> str:
        """String for model-file feature_infos (bin.h:162-171)."""
        if self.bin_type == CATEGORICAL:
            return ":".join(str(int(c)) for c in self.bin_2_categorical)
        return "[%s:%s]" % (repr(self.min_val), repr(self.max_val))

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d = {
            "num_bin": self.num_bin,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
        }
        if self.bin_type == NUMERICAL:
            d["bin_upper_bound"] = None if self.bin_upper_bound is None \
                else self.bin_upper_bound.tolist()
        else:
            d["bin_2_categorical"] = None if self.bin_2_categorical is None \
                else [int(c) for c in self.bin_2_categorical]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        """The mapper ``to_dict`` wrote (binary dataset files)."""
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        if m.bin_type == NUMERICAL:
            if d.get("bin_upper_bound") is not None:
                m.bin_upper_bound = np.asarray(d["bin_upper_bound"],
                                               dtype=np.float64)
        elif d.get("bin_2_categorical") is not None:
            m.bin_2_categorical = np.asarray(d["bin_2_categorical"],
                                             dtype=np.int64)
            m.categorical_2_bin = {int(c): i for i, c in
                                   enumerate(m.bin_2_categorical)}
        return m
