"""The port's ComplexArray against the JAX package's class, on the CPU:
the same numpy inputs through both, every result bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.carray import is_planar as j_is_planar
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.carray import is_planar as t_is_planar


def _planes(shape, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


def _pair(shape, seed):
    re, im = _planes(shape, seed)
    return (JCA(jnp.asarray(re), jnp.asarray(im)),
            TCA(torch.from_numpy(re), torch.from_numpy(im)))


def _equal(got, want):
    """A port result (ComplexArray or tensor) bit-equal to JAX's."""
    if isinstance(want, JCA):
        assert isinstance(got, TCA)
        _equal(got.re, want.re)
        _equal(got.im, want.im)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,new", [((12,), (3, 4)), ((2, 6), (12,)),
                                       ((2, 3, 4), (4, -1))])
def test_reshape_matches_jax(shape, new):
    j, t = _pair(shape, 1)
    _equal(t.reshape(*new), j.reshape(*new))
    _equal(t.reshape(new), j.reshape(new))


@pytest.mark.parametrize("op", ["__add__", "__sub__", "__mul__"])
@pytest.mark.parametrize("other", ["planar", "scalar", "real_array"])
def test_arithmetic_matches_jax(op, other):
    """ComplexArray op ComplexArray, op a Python float, op a real array
    (broadcast over the leading axis): a real operand acts on the real
    plane alone for + and -, on both planes for *, as in JAX's class."""
    j, t = _pair((3, 5), 2)
    if other == "planar":
        jo, to = _pair((3, 5), 3)
    elif other == "scalar":
        jo = to = 0.375
    else:
        arr = _planes((5,), 4)[0]
        jo, to = jnp.asarray(arr), torch.from_numpy(arr)
    _equal(getattr(t, op)(to), getattr(j, op)(jo))


def test_abs2_abs_conj_match_jax():
    """Also at the edges of |z|: zeros, an infinite plane, a NaN, tiny and
    huge planes."""
    j, t = _pair((4, 33), 5)
    _equal(t.abs2(), j.abs2())
    _equal(t.abs(), j.abs())
    _equal(t.conj(), j.conj())
    _equal(t[1:3, ::2], j[1:3, ::2])
    edge_re = np.array([0.0, -0.0, np.inf, 3.0, np.nan, 1e-30, 3e38, -2.0],
                       np.float32)
    edge_im = np.array([0.0, 5.0, 1.0, -np.inf, 1.0, 1e-30, 3e38, 0.0],
                       np.float32)
    j = JCA(jnp.asarray(edge_re), jnp.asarray(edge_im))
    t = TCA(torch.from_numpy(edge_re), torch.from_numpy(edge_im))
    _equal(t.abs2(), j.abs2())
    _equal(t.abs(), j.abs())


def test_is_planar_matches_jax():
    j, t = _pair((4,), 6)
    assert t_is_planar(t) and j_is_planar(j)
    assert not t_is_planar(t.re) and not j_is_planar(j.re)
    assert not t_is_planar(None) and not j_is_planar(None)


def test_pytree_methods_match_jax():
    """tree_flatten gives the planes in JAX's order with no aux data, and
    tree_unflatten rebuilds the array; a JAX pytree walk of the JAX array
    and the port's walk agree leaf for leaf."""
    j, t = _pair((2, 3), 7)
    (tre, tim), taux = t.tree_flatten()
    (jre, jim), jaux = j.tree_flatten()
    assert taux is None and jaux is None
    assert tre is t.re and tim is t.im
    _equal(tre, jre)
    _equal(tim, jim)
    back = TCA.tree_unflatten(taux, (tre, tim))
    assert isinstance(back, TCA) and back.re is t.re and back.im is t.im
    for got, want in zip((tre, tim), jax.tree_util.tree_leaves(j)):
        _equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_zeros_takes_dtype_by_position_as_jax(dtype):
    """``zeros(shape, dtype)``: the dtype by position, as JAX's
    ``zeros(shape, dtype=jnp.float32)``, float64 planes as JAX's under x64
    (float32 by default); ``device`` by keyword after it."""
    with jax.enable_x64(True):
        j = JCA.zeros((2, 3), getattr(jnp, dtype))
        _equal(TCA.zeros((2, 3), getattr(torch, dtype)), j)
    _equal(TCA.zeros((2, 3)), JCA.zeros((2, 3)))
    t = TCA.zeros((4,), getattr(torch, dtype), device="cpu")
    assert t.re.dtype == t.im.dtype == getattr(torch, dtype)
    assert t.device == torch.device("cpu") and t.shape == (4,)
    assert TCA.zeros((1,), device="cpu").re.dtype == torch.float32
