"""Checkpoint and resume of streaming states.

Counterpart of ``gsdr_tpu/utils/checkpoint.py``: a state (the nested
tuples, lists and dicts of tensors, planar ComplexArrays and Python
scalars that the port's models carry) is written to numpy's ``.npz``, one
array per leaf, under the key that ``jax.tree_util.keystr`` gives the same
leaf of the JAX package's state: '[i]' for an item of a tuple or list,
"['k']" for a dict entry (keys in sorted order), '.name' for a field of a
namedtuple, '[<flat index i>]' for the planes of a ComplexArray (a JAX
pytree node class without keys). A None is no leaf. So a file written by
either package loads in the other, bit-exactly.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.utils.tree import tree_flatten, tree_unflatten


def _children(node):
    """[(key string, child)] of an inner node, or None for a leaf."""
    if isinstance(node, ComplexArray):
        return [("[<flat index 0>]", node.re), ("[<flat index 1>]", node.im)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    return None


def flatten_with_keys(state, prefix=""):
    """[(key string, leaf)] of a state, in JAX's flattening order."""
    if state is None:
        return []
    kids = _children(state)
    if kids is None:
        return [(prefix, state)]
    out = []
    for key, child in kids:
        out.extend(flatten_with_keys(child, prefix + key))
    return out


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path, state):
    """Write a state to ``path`` (.npz), one array per leaf."""
    np.savez(path, **{k: _to_numpy(v) for k, v in flatten_with_keys(state)})


def _like_leaf(key, arr, tmpl):
    """The stored array as the template leaf: a tensor of its dtype on its
    device, a numpy array of its dtype, or a Python scalar of its type."""
    shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"leaf {key!r} shape {arr.shape} != template {shape}")
    if isinstance(tmpl, torch.Tensor):
        return torch.as_tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, np.ndarray):
        return arr.astype(tmpl.dtype)
    return type(tmpl)(arr.item())


def load_state(path, like):
    """Load a state written by ``save_state`` (of either package).

    ``like`` is a template of the same structure, such as a fresh
    ``model.init()``: each leaf is replaced by the stored array, with the
    template leaf's dtype and device. A missing key raises KeyError, a
    shape that differs from the template's ValueError.
    """
    with np.load(path) as data:
        leaves = []
        for key, tmpl in flatten_with_keys(like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            leaves.append(_like_leaf(key, data[key], tmpl))
    return tree_unflatten(tree_flatten(like)[1], leaves)
