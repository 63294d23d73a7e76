"""Model text file -> PMML 4.2 TreeModel ensemble.

Parity target: pmml/pmml.py in the reference (same element structure:
DataDictionary + MiningModel/Segmentation of TreeModel segments with
SimplePredicate nodes; categorical splits use equal/notEqual, numerical
lessOrEqual/greaterThan).  The same document as the JAX package's
``pmml.py`` for the same model.
"""
from __future__ import annotations

from typing import List

from .models.gbdt import GBDT
from .models.tree import Tree


def _node_xml(out: List[str], tree: Tree, node_id: int, tab: int,
              is_left: bool, prev_node: int, uid: List[int],
              feature_names: List[str]) -> None:
    if node_id < 0:
        leaf = ~node_id
        score = tree.leaf_value[leaf]
        record_count = tree.leaf_count[leaf]
        pred_idx = tree.leaf_parent[leaf]
        is_leaf = True
    else:
        score = tree.internal_value[node_id]
        record_count = tree.internal_count[node_id]
        pred_idx = prev_node
        is_leaf = False
    out.append("\t" * tab + '<Node id="%d" score="%s" recordCount="%d">'
               % (uid[0], repr(float(score)), record_count))
    uid[0] += 1
    # predicate against the PARENT split (pmml.py print_simple_predicate)
    idx = tree.leaf_parent[~node_id] if is_leaf and node_id < 0 else prev_node
    if idx >= 0:
        if is_left:
            op = "equal" if tree.decision_type[idx] == 1 else "lessOrEqual"
        else:
            op = "notEqual" if tree.decision_type[idx] == 1 else "greaterThan"
        out.append("\t" * (tab + 1) +
                   '<SimplePredicate field="%s" operator="%s" value="%s" />'
                   % (feature_names[tree.split_feature[idx]], op,
                      repr(float(tree.threshold[idx]))))
    else:
        out.append("\t" * (tab + 1) + "<True />")
    if not is_leaf:
        _node_xml(out, tree, tree.left_child[node_id], tab + 1, True,
                  node_id, uid, feature_names)
        _node_xml(out, tree, tree.right_child[node_id], tab + 1, False,
                  node_id, uid, feature_names)
    out.append("\t" * tab + "</Node>")


def model_to_pmml(gbdt: GBDT) -> str:
    gbdt._materialize()
    feature_names = list(gbdt.feature_names) or [
        "Column_%d" % i for i in range(gbdt.max_feature_idx + 1)]
    out: List[str] = ['<?xml version="1.0"?>',
                      '<PMML version="4.2" xmlns="http://www.dmg.org/PMML-4_2">',
                      "\t<Header copyright=\"lightgbm_tpu\"/>",
                      "\t<DataDictionary numberOfFields=\"%d\">"
                      % (len(feature_names) + 1),
                      '\t\t<DataField name="prediction" optype="continuous" '
                      'dataType="double"/>']
    for name in feature_names:
        out.append('\t\t<DataField name="%s" optype="continuous" '
                   'dataType="double"/>' % name)
    out.append("\t</DataDictionary>")
    out.append('\t<MiningModel modelName="lightgbm_tpu" functionName="regression">')
    out.append("\t\t<MiningSchema>")
    for name in feature_names:
        out.append('\t\t\t<MiningField name="%s"/>' % name)
    out.append("\t\t</MiningSchema>")
    out.append('\t\t<Segmentation multipleModelMethod="sum">')
    for i, tree in enumerate(gbdt.models):
        out.append('\t\t\t<Segment id="%d">' % (i + 1))
        out.append("\t\t\t\t<True />")
        out.append('\t\t\t\t<TreeModel modelName="tree_%d" functionName="regression" '
                   'splitCharacteristic="binarySplit">' % i)
        out.append("\t\t\t\t\t<MiningSchema>")
        for name in feature_names:
            out.append('\t\t\t\t\t\t<MiningField name="%s"/>' % name)
        out.append("\t\t\t\t\t</MiningSchema>")
        uid = [0]
        body: List[str] = []
        if tree.num_leaves > 1:
            _node_xml(body, tree, 0, 5, True, -1, uid, feature_names)
        else:
            body.append("\t" * 5 + '<Node id="0" score="%s" recordCount="0">'
                        % repr(float(tree.leaf_value[0])))
            body.append("\t" * 6 + "<True />")
            body.append("\t" * 5 + "</Node>")
        out.extend(body)
        out.append("\t\t\t\t</TreeModel>")
        out.append("\t\t\t</Segment>")
    out.append("\t\t</Segmentation>")
    out.append("\t</MiningModel>")
    out.append("</PMML>")
    return "\n".join(out) + "\n"


def convert_model_file_to_pmml(model_path: str, out_path: str) -> None:
    """Write the PMML of a model file (read on the host)."""
    import torch

    from .utils.config import Config
    gbdt = GBDT(Config(), torch.device("cpu"))
    with open(model_path) as f:
        gbdt.load_model_from_string(f.read())
    with open(out_path, "w") as f:
        f.write(model_to_pmml(gbdt))
