"""Host-side structural BVH validation (reference: src/Utilities.cpp).

Port of ``tpu_raytracing/bvh/verify.py`` (``HierarchyStats``,
``count_nodes``, ``verify_hierarchy``, ``leaf_primitive_ids``), in host
numpy as in the reference. The reference walks the tree with a Python
stack, one node at a time (about 500k nodes at 1M triangles); here the walk
goes level by level over numpy arrays. On a tree it gives the same counts,
the same set of offending indices (in level order rather than the
reference's stack order) and the same primitive ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_TRI


@dataclasses.dataclass
class HierarchyStats:
    num_nodes: int = 0
    num_tree_nodes: int = 0
    num_leaf_nodes: int = 0


def _as_numpy(bvh):
    return (bvh.node_min.cpu().numpy(), bvh.node_max.cpu().numpy(),
            bvh.child.cpu().numpy().astype(np.int64), bvh.count.cpu().numpy().astype(np.int64),
            bvh.type.cpu().numpy(), int(bvh.root), int(bvh.root_count))


def _levels(child, count, ntype, root, root_count):
    """Yield (box nodes, their children in node order) level by level from
    the root group's Box slots."""
    roots = np.arange(root, root + root_count)
    nodes = roots[ntype[roots] == CHILD_BOX]
    while nodes.size:
        counts = count[nodes]
        starts = np.cumsum(counts) - counts
        owner = np.repeat(np.arange(nodes.shape[0]), counts)
        kids = child[nodes][owner] + (np.arange(owner.shape[0]) - starts[owner])
        yield nodes, kids
        nodes = kids[ntype[kids] == CHILD_BOX]


def count_nodes(bvh) -> HierarchyStats:
    """CountNodes (src/Utilities.cpp:8-44)."""
    _, _, child, count, ntype, root, root_count = _as_numpy(bvh)
    stats = HierarchyStats()
    roots = np.arange(root, root + root_count)
    n_root = int((ntype[roots] == CHILD_BOX).sum())
    stats.num_nodes = stats.num_tree_nodes = n_root
    for _, kids in _levels(child, count, ntype, root, root_count):
        stats.num_nodes += int(kids.shape[0])
        stats.num_leaf_nodes += int((ntype[kids] == CHILD_TRI).sum())
        stats.num_tree_nodes += int((ntype[kids] == CHILD_BOX).sum())
    return stats


def verify_hierarchy(bvh, exact: bool = True) -> list:
    """VerifyHierarchy (src/Utilities.cpp:46-84): every interior box must
    equal the exact union of its children's (with ``exact=False``, contain
    it to 1e-6). Returns the offending node indices (empty == valid)."""
    node_min, node_max, child, count, ntype, root, root_count = _as_numpy(bvh)
    errors = []
    for nodes, kids in _levels(child, count, ntype, root, root_count):
        if (count[nodes] <= 0).any():
            raise ValueError("verify_hierarchy: a Box node has no children")
        starts = np.cumsum(count[nodes]) - count[nodes]
        cmin = np.minimum.reduceat(node_min[kids], starts, axis=0)
        cmax = np.maximum.reduceat(node_max[kids], starts, axis=0)
        if exact:
            ok = (node_min[nodes] == cmin).all(axis=1) & (node_max[nodes] == cmax).all(axis=1)
        else:
            ok = ((node_min[nodes] <= cmin + 1e-6).all(axis=1)
                  & (node_max[nodes] >= cmax - 1e-6).all(axis=1))
        errors.extend(int(i) for i in nodes[~ok])
    return errors


def leaf_primitive_ids(bvh, pairs) -> np.ndarray:
    """All primitive ids reachable from the root, sorted (coverage check)."""
    _, _, child, count, ntype, root, root_count = _as_numpy(bvh)
    prim0 = pairs.prim_id_0.cpu().numpy()
    prim1 = pairs.prim_id_1.cpu().numpy()
    roots = np.arange(root, root + root_count)
    leaves = [roots[ntype[roots] == CHILD_TRI]]
    for _, kids in _levels(child, count, ntype, root, root_count):
        leaves.append(kids[ntype[kids] == CHILD_TRI])
    p = child[np.concatenate(leaves)]
    out = np.concatenate([prim0[p], prim1[p][prim1[p] != prim0[p]]])
    return np.sort(out.astype(np.int64))
