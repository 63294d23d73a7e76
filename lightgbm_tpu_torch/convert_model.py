"""Model -> standalone C++ if-else predictor source (convert_model task).

Parity target: GBDT::SaveModelToIfElse / Tree::ToIfElse
(src/boosting/gbdt.cpp:701-790, src/io/tree.cpp) — emits compilable C++ with
one function per tree plus a PredictRaw aggregator, used by the reference's
cpp determinism test (tests/cpp_test).  The generated code reproduces the
zero-range default redirect and categorical `is` decisions.  The same
text as the JAX package's ``convert_model.py`` for the same model.
"""
from __future__ import annotations

from typing import List

from .models.gbdt import GBDT
from .models.tree import Tree

_HEADER = """// generated by lightgbm_tpu convert_model
#include <cmath>
#include <cstring>

namespace lightgbm_tpu_gen {

static inline double DefaultValueForZero(double fval, double out) {
  if (fval > -1e-20 && fval <= 1e-20) return out;
  return fval;
}
"""


def _node_code(tree: Tree, index: int, indent: int) -> List[str]:
    pad = "  " * indent
    if index < 0:
        leaf = ~index
        return ["%sreturn %r;" % (pad, float(tree.leaf_value[leaf]))]
    fval = "DefaultValueForZero(arr[%d], %r)" % (
        tree.split_feature[index], float(tree.default_value[index]))
    if tree.decision_type[index] == 1:
        cond = "(long long)(%s) == (long long)(%r)" % (
            fval, float(tree.threshold[index]))
    else:
        cond = "%s <= %r" % (fval, float(tree.threshold[index]))
    out = ["%sif (%s) {" % (pad, cond)]
    out += _node_code(tree, tree.left_child[index], indent + 1)
    out += ["%s} else {" % pad]
    out += _node_code(tree, tree.right_child[index], indent + 1)
    out += ["%s}" % pad]
    return out


def tree_to_if_else(tree: Tree, index: int) -> str:
    lines = ["double PredictTree%d(const double* arr) {" % index]
    if tree.num_leaves <= 1:
        lines.append("  return %r;" % float(tree.leaf_value[0]))
    else:
        lines += _node_code(tree, 0, 1)
    lines.append("}")
    return "\n".join(lines)


def model_to_cpp(gbdt: GBDT) -> str:
    """Full translation unit: per-tree functions + PredictRaw."""
    gbdt._materialize()
    parts = [_HEADER]
    for i, tree in enumerate(gbdt.models):
        parts.append(tree_to_if_else(tree, i))
    k = gbdt.num_tree_per_iteration
    body = ["extern \"C\" void PredictRaw(const double* arr, double* out) {",
            "  for (int i = 0; i < %d; ++i) out[i] = 0.0;" % k]
    for i in range(len(gbdt.models)):
        body.append("  out[%d] += PredictTree%d(arr);" % (i % k, i))
    body.append("}")
    parts.append("\n".join(body))
    parts.append("}  // namespace lightgbm_tpu_gen")
    parts.append("""
extern "C" void LGBMTPU_GenPredictRaw(const double* arr, double* out) {
  lightgbm_tpu_gen::PredictRaw(arr, out);
}
""")
    return "\n\n".join(parts)
