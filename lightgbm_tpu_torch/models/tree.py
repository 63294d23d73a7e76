"""Tree model: flat-array binary tree with the text model format.

Parity target: include/LightGBM/tree.h + src/io/tree.cpp.  Layout is the
reference's SoA scheme (tree.h:195-229): internal nodes indexed 0..n-2, leaves
addressed as bitwise-complement (~leaf) in child arrays.  The text format
written by ``to_string`` matches Tree::ToString (tree.cpp:312-343) so model
files interchange with the reference line.

Decision semantics (tree.h:229-276):
* numerical: fval <= threshold -> left;  categorical: int(fval) == threshold;
* a feature value in the zero range (-1e-20, 1e-20] is replaced by the node's
  ``default_value`` before the comparison (DefaultValueForZero).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.common import (array_to_string, avoid_inf, kMaxTreeOutput,
                            kMissingValueRange, parse_kv_lines, string_to_array)
from ..utils.log import Log


class NodeArrays(NamedTuple):
    """Per-internal-node SoA views of one tree, trimmed to the realized
    node count (Tree.node_arrays) — the unit the stacked device predictor
    packs without per-node Python loops."""
    split_feature: np.ndarray   # (ni,) i32 real (outer) feature index
    threshold: np.ndarray       # (ni,) f64
    decision_type: np.ndarray   # (ni,) i8 (1 = categorical)
    default_value: np.ndarray   # (ni,) f64 zero-range replacement value
    left_child: np.ndarray      # (ni,) i32 (~leaf for leaves)
    right_child: np.ndarray     # (ni,) i32


class Tree:
    def __init__(self, max_leaves: int = 2):
        self.max_leaves = max(int(max_leaves), 1)
        n = self.max_leaves
        self.num_leaves = 1
        # per internal node (n-1)
        self.left_child = np.zeros(n - 1, dtype=np.int32)
        self.right_child = np.zeros(n - 1, dtype=np.int32)
        self.split_feature_inner = np.zeros(n - 1, dtype=np.int32)
        self.split_feature = np.zeros(n - 1, dtype=np.int32)
        self.threshold_in_bin = np.zeros(n - 1, dtype=np.int32)
        self.threshold = np.zeros(n - 1, dtype=np.float64)
        self.decision_type = np.zeros(n - 1, dtype=np.int8)
        self.default_value = np.zeros(n - 1, dtype=np.float64)
        self.zero_bin = np.zeros(n - 1, dtype=np.int32)
        self.default_bin_for_zero = np.zeros(n - 1, dtype=np.int32)
        self.split_gain = np.zeros(n - 1, dtype=np.float64)
        self.internal_value = np.zeros(n - 1, dtype=np.float64)
        self.internal_count = np.zeros(n - 1, dtype=np.int64)
        # the split audit's runner-up (not in the text format): the real
        # feature index of the second-best candidate of each split and its
        # gain; -1 / 0 where the winner had no competitor, and in trees
        # loaded from text
        self.second_feature = np.full(n - 1, -1, dtype=np.int32)
        self.second_gain = np.zeros(n - 1, dtype=np.float64)
        # per leaf (n)
        self.leaf_parent = np.zeros(n, dtype=np.int32)
        self.leaf_value = np.zeros(n, dtype=np.float64)
        self.leaf_count = np.zeros(n, dtype=np.int64)
        self.leaf_depth = np.zeros(n, dtype=np.int32)
        self.leaf_parent[0] = -1
        self.shrinkage = 1.0
        self.has_categorical = False
        # trees read from the text format carry only real-valued
        # thresholds (tree.cpp:312-343): no binned traversal of them
        self.has_bin_thresholds = True

    # ---------------------------------------------------------------- build
    def split(self, leaf: int, inner_feature: int, bin_type_categorical: bool,
              threshold_bin: int, real_feature: int, threshold_double: float,
              left_value: float, right_value: float, left_cnt: int,
              right_cnt: int, gain: float, zero_bin: int,
              default_bin_for_zero: int, default_value: float) -> int:
        """Tree::Split (tree.cpp:55-110); returns the new (right) leaf id."""
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = inner_feature
        self.split_feature[new_node] = real_feature
        self.zero_bin[new_node] = zero_bin
        self.default_bin_for_zero[new_node] = default_bin_for_zero
        self.default_value[new_node] = avoid_inf(default_value)
        if bin_type_categorical:
            self.decision_type[new_node] = 1
            self.has_categorical = True
        else:
            self.decision_type[new_node] = 0
        self.threshold_in_bin[new_node] = threshold_bin
        self.threshold[new_node] = avoid_inf(threshold_double)
        self.split_gain[new_node] = avoid_inf(gain)
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if np.isnan(left_value) else left_value
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = 0.0 if np.isnan(right_value) else right_value
        self.leaf_count[self.num_leaves] = right_cnt
        depth = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] = depth
        self.leaf_depth[self.num_leaves] = depth
        self.num_leaves += 1
        return self.num_leaves - 1

    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage with the ±100 output clamp (tree.h:110-118)."""
        lv = self.leaf_value[:self.num_leaves] * rate
        self.leaf_value[:self.num_leaves] = np.clip(lv, -kMaxTreeOutput, kMaxTreeOutput)
        self.shrinkage *= rate

    def node_arrays(self) -> "NodeArrays":
        """Trimmed per-internal-node views (num_leaves - 1 entries) for
        bulk packing into stacked device tree arrays (ops/predict.py
        build_ranked_predictor).  Views, not copies — callers must not
        mutate."""
        ni = max(self.num_leaves - 1, 0)
        return NodeArrays(
            split_feature=self.split_feature[:ni],
            threshold=self.threshold[:ni],
            decision_type=self.decision_type[:ni],
            default_value=self.default_value[:ni],
            left_child=self.left_child[:ni],
            right_child=self.right_child[:ni])

    def depth(self) -> int:
        """Steps of the deepest descent from the root to a leaf (0 for a
        one-leaf tree), from the child arrays alone: a tree loaded from
        model text carries no leaf depths.  A child node always has a
        larger index than its parent, so the parent links are a forest
        walked upward one level a step."""
        ni = self.num_leaves - 1
        if ni <= 0:
            return 0
        parent = np.full(ni, -1, np.int64)
        for child in (self.left_child[:ni], self.right_child[:ni]):
            inner = child >= 0
            parent[child[inner]] = np.nonzero(inner)[0]
        depth = np.zeros(ni, np.int64)
        up = parent
        while (up >= 0).any():
            depth += up >= 0
            up = np.where(up >= 0, parent[np.maximum(up, 0)], -1)
        return int(depth.max()) + 1

    # -------------------------------------------------------------- predict
    def predict(self, features: np.ndarray) -> np.ndarray:
        """Batch predict on raw feature values, vectorized over rows.

        Mirrors Tree::GetLeaf (tree.h:250-276): iterative descent with the
        zero-range default redirect.
        """
        leaves = self.predict_leaf_index(features)
        if self.num_leaves <= 1:
            return np.zeros(features.shape[0], dtype=np.float64)
        return self.leaf_value[leaves]

    def predict_leaf_index(self, features: np.ndarray) -> np.ndarray:
        n = features.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        active = node >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            nd = node[idx]
            feat = self.split_feature[nd]
            fval = features[idx, feat]
            dv = self.default_value[nd]
            use_default = (fval > -kMissingValueRange) & (fval <= kMissingValueRange)
            fval = np.where(use_default, dv, fval)
            is_cat = self.decision_type[nd] == 1
            th = self.threshold[nd]
            with np.errstate(invalid="ignore"):
                go_left = np.where(
                    is_cat,
                    fval.astype(np.int64, copy=False) == th.astype(np.int64),
                    fval <= th)
            # NaN comparisons are False -> right, matching C++ operator<=
            node[idx] = np.where(go_left, self.left_child[nd], self.right_child[nd])
            active = node >= 0
        return (~node).astype(np.int32)

    def predict_contrib(self, features: np.ndarray,
                        num_features: int) -> np.ndarray:
        """Gain-weighted per-feature attribution of this tree's output.

        One descent (same semantics as predict_leaf_index) recording the
        visited nodes per depth level; each row's leaf value is then
        distributed over its path's split features proportionally to
        split gain.  Returns (N, num_features + 1): the last column is
        the bias — rows whose path carries no positive gain (stub trees,
        loaded models without gains) put the whole leaf value there.
        Rows sum to predict(features) up to one rounding per path node.
        """
        n = features.shape[0]
        out = np.zeros((n, num_features + 1), dtype=np.float64)
        if self.num_leaves <= 1:
            return out
        values = self.leaf_value[self.predict_leaf_index(features)]
        steps = []          # (rows, nodes) per depth level of the descent
        node = np.zeros(n, dtype=np.int32)
        active = node >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            nd = node[idx]
            steps.append((idx, nd))
            feat = self.split_feature[nd]
            fval = features[idx, feat]
            dv = self.default_value[nd]
            use_default = (fval > -kMissingValueRange) & \
                (fval <= kMissingValueRange)
            fval = np.where(use_default, dv, fval)
            is_cat = self.decision_type[nd] == 1
            th = self.threshold[nd]
            with np.errstate(invalid="ignore"):
                go_left = np.where(
                    is_cat,
                    fval.astype(np.int64, copy=False) == th.astype(np.int64),
                    fval <= th)
            node[idx] = np.where(go_left, self.left_child[nd],
                                 self.right_child[nd])
            active = node >= 0
        total = np.zeros(n, dtype=np.float64)
        for idx, nd in steps:
            g = self.split_gain[nd]
            total[idx] += np.where(g > 0, g, 0.0)
        no_gain = total <= 0
        out[no_gain, num_features] = values[no_gain]
        scale = np.where(no_gain, 0.0,
                         values / np.where(no_gain, 1.0, total))
        for idx, nd in steps:
            g = self.split_gain[nd]
            np.add.at(out, (idx, self.split_feature[nd]),
                      np.where(g > 0, g, 0.0) * scale[idx])
        return out

    # ------------------------------------------------------------ serialize
    def to_string(self) -> str:
        """Tree::ToString field order (tree.cpp:312-343)."""
        nl = self.num_leaves
        ni = nl - 1
        buf = ["num_leaves=%d" % nl]
        buf.append("split_feature=" + array_to_string(self.split_feature[:ni]))
        buf.append("split_gain=" + array_to_string(self.split_gain[:ni]))
        buf.append("threshold=" + array_to_string(self.threshold[:ni]))
        buf.append("decision_type=" + array_to_string(self.decision_type[:ni]))
        buf.append("default_value=" + array_to_string(self.default_value[:ni]))
        buf.append("left_child=" + array_to_string(self.left_child[:ni]))
        buf.append("right_child=" + array_to_string(self.right_child[:ni]))
        buf.append("leaf_parent=" + array_to_string(self.leaf_parent[:nl]))
        buf.append("leaf_value=" + array_to_string(self.leaf_value[:nl]))
        buf.append("leaf_count=" + array_to_string(self.leaf_count[:nl]))
        buf.append("internal_value=" + array_to_string(self.internal_value[:ni]))
        buf.append("internal_count=" + array_to_string(self.internal_count[:ni]))
        buf.append("shrinkage=%s" % repr(self.shrinkage))
        buf.append("has_categorical=%d" % (1 if self.has_categorical else 0))
        buf.append("")
        return "\n".join(buf) + "\n"

    @classmethod
    def from_string(cls, s: str) -> "Tree":
        """Tree(const std::string&) loader (tree.cpp:443-552)."""
        kv = parse_kv_lines(s.splitlines())
        if "num_leaves" not in kv:
            Log.fatal("Tree model should contain num_leaves field.")
        num_leaves = int(kv["num_leaves"])
        self = cls(max(num_leaves, 2))
        self.num_leaves = num_leaves
        if num_leaves <= 1:
            return self
        ni, nl = num_leaves - 1, num_leaves

        def req(key, dtype, count):
            if key not in kv:
                Log.fatal("Tree model string format error, should contain %s field", key)
            return string_to_array(kv[key], dtype)[:count]

        self.left_child[:ni] = req("left_child", np.int32, ni)
        self.right_child[:ni] = req("right_child", np.int32, ni)
        self.split_feature[:ni] = req("split_feature", np.int32, ni)
        self.threshold[:ni] = req("threshold", np.float64, ni)
        self.default_value[:ni] = req("default_value", np.float64, ni)
        self.leaf_value[:nl] = req("leaf_value", np.float64, nl)
        if "decision_type" in kv:
            self.decision_type[:ni] = string_to_array(kv["decision_type"], np.float64)[:ni].astype(np.int8)
        if "split_gain" in kv:
            self.split_gain[:ni] = string_to_array(kv["split_gain"], np.float64)[:ni]
        if "leaf_parent" in kv:
            self.leaf_parent[:nl] = string_to_array(kv["leaf_parent"], np.int32)[:nl]
        if "leaf_count" in kv:
            self.leaf_count[:nl] = string_to_array(kv["leaf_count"], np.float64)[:nl].astype(np.int64)
        if "internal_value" in kv:
            self.internal_value[:ni] = string_to_array(kv["internal_value"], np.float64)[:ni]
        if "internal_count" in kv:
            self.internal_count[:ni] = string_to_array(kv["internal_count"], np.float64)[:ni].astype(np.int64)
        if "shrinkage" in kv:
            self.shrinkage = float(kv["shrinkage"])
        if "has_categorical" in kv:
            self.has_categorical = int(kv["has_categorical"]) != 0
        self.has_bin_thresholds = False
        return self

    def to_json(self) -> str:
        """Tree::ToJSON (tree.cpp:345-358), character for character the
        JAX package's: floats through repr."""
        out = ['"num_leaves":%d,' % self.num_leaves,
               '"shrinkage":%s,' % repr(float(self.shrinkage)),
               '"has_categorical":%d,' % (1 if self.has_categorical else 0)]
        root = -1 if self.num_leaves == 1 else 0
        out.append('"tree_structure":' + self._node_to_json(root))
        return "\n".join(out) + "\n"

    def _node_to_json(self, index: int) -> str:
        """A node (index >= 0) or leaf (~index) and its subtree."""
        if index >= 0:
            return ("{\n"
                    '"split_index":%d,\n'
                    '"split_feature":%d,\n'
                    '"split_gain":%s,\n'
                    '"threshold":%s,\n'
                    '"decision_type":"%s",\n'
                    '"default_value":%s,\n'
                    '"internal_value":%s,\n'
                    '"internal_count":%d,\n'
                    '"left_child":%s,\n'
                    '"right_child":%s\n'
                    "}") % (
                index, self.split_feature[index],
                repr(float(self.split_gain[index])),
                repr(float(self.threshold[index])),
                "no_greater" if self.decision_type[index] == 0 else "is",
                repr(float(self.default_value[index])),
                repr(float(self.internal_value[index])),
                self.internal_count[index],
                self._node_to_json(self.left_child[index]),
                self._node_to_json(self.right_child[index]))
        leaf = ~index
        return ("{\n"
                '"leaf_index":%d,\n'
                '"leaf_parent":%d,\n'
                '"leaf_value":%s,\n'
                '"leaf_count":%d\n'
                "}") % (leaf, self.leaf_parent[leaf],
                        repr(float(self.leaf_value[leaf])),
                        self.leaf_count[leaf])
