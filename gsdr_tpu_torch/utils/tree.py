"""Flatten and rebuild the port's state trees.

The JAX package's states are pytrees: nested tuples, lists, dicts and
namedtuples of arrays and ``ComplexArray``s (a registered pytree class),
with None as an empty subtree. ``tree_flatten`` gives the leaves in JAX's
order (dict entries by sorted key, a ComplexArray's planes by its own
``tree_flatten``) and a hashable structure; ``tree_unflatten`` puts
leaves back into it. A leaf is anything else: a tensor, a numpy array, a
Python scalar.
"""

from gsdr_tpu_torch.carray import ComplexArray

_LEAF = "*"
_END = object()


def _flatten(node, leaves):
    if node is None:
        return None
    if isinstance(node, ComplexArray):
        children, aux = node.tree_flatten()
        return (ComplexArray, aux,
                tuple(_flatten(c, leaves) for c in children))
    if isinstance(node, (tuple, list)):
        return (type(node), None, tuple(_flatten(c, leaves) for c in node))
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, (tuple(node), tuple(keys)),
                tuple(_flatten(node[k], leaves) for k in keys))
    leaves.append(node)
    return _LEAF


def tree_flatten(tree):
    """(leaves, treedef) of a state tree; treedef is hashable."""
    leaves = []
    return leaves, _flatten(tree, leaves)


def _unflatten(treedef, leaves):
    if treedef is None:
        return None
    if treedef == _LEAF:
        return next(leaves)
    kind, aux, children = treedef
    kids = [_unflatten(c, leaves) for c in children]
    if kind is ComplexArray:
        return ComplexArray.tree_unflatten(aux, kids)
    if kind is dict:
        order, keys = aux
        by_key = dict(zip(keys, kids))
        return {k: by_key[k] for k in order}
    if hasattr(kind, "_fields"):
        return kind(*kids)
    return kind(kids)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flattening order."""
    it = iter(leaves)
    tree = _unflatten(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return tree
