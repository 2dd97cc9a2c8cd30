"""The port's ``repro_torch.sparse.masks`` against the reference's
``repro.sparse.masks`` on the same seeded numpy inputs.

``magnitude_prune`` keeps every weight whose magnitude is ``>=`` the k-th
largest (``k = max(int(size · density), 1)``), so ties at the threshold are
all kept: the inputs here draw small integers, which tie often, as well as
continuous values and a tensor that is all one magnitude.
``activation_density`` is the fp32 fraction of ``|x| > atol`` in ``x``'s
dtype, ``density`` the fraction of non-zeros.  ``nm_prune`` and
``block_prune`` are held to the reference elsewhere (the compressed
plane's tests); ties in them are checked here too.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.sparse import masks as rmasks
from repro_torch.sparse import masks


def _weights(kind: str, shape=(64, 48), seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":          # small integers with signs: many ties
        return rng.integers(-3, 4, shape).astype(np.float32)
    if kind == "flat":          # one magnitude everywhere
        return np.where(rng.random(shape) < 0.5, -1.5, 1.5).astype(
            np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "flat"])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25, 0.5, 0.7, 1.0])
def test_magnitude_prune_equals_the_references(kind, frac):
    w = _weights(kind, seed=int(frac * 10))
    want = np.asarray(rmasks.magnitude_prune(jnp.asarray(w), frac))
    got = masks.magnitude_prune(torch.from_numpy(w), frac)
    assert got.dtype == torch.float32 and got.shape == w.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # ties at the threshold are all kept: never fewer than k survivors
    k = max(int(w.size * frac), 1)
    assert int(np.count_nonzero(want)) >= min(k, np.count_nonzero(w))


@pytest.mark.parametrize("shape", [(7,), (5, 3, 4), (1, 1)])
def test_magnitude_prune_takes_any_shape(shape):
    w = _weights("ties", shape=shape, seed=3)
    for frac in (0.3, 0.9):
        np.testing.assert_array_equal(
            masks.magnitude_prune(torch.from_numpy(w), frac).numpy(),
            np.asarray(rmasks.magnitude_prune(jnp.asarray(w), frac)))


@pytest.mark.parametrize("atol", [0.0, 0.1, 1.0, 2.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_density_equals_the_references(atol, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((33, 65)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0.0            # ReLU-style zeros
    x[0, :8] = [0.1, -0.1, 1.0, -1.0, 2.5, -2.5, 0.0, -0.0]   # at atol
    if dtype == "bfloat16":
        xj = jnp.asarray(x.astype(ml_dtypes.bfloat16))
        xt = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(xt.float().numpy(),
                              np.asarray(xj, np.float32))
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = rmasks.activation_density(xj, atol)
    got = masks.activation_density(xt, atol)
    assert isinstance(got, float) and got == want


@pytest.mark.parametrize("kind", ["normal", "ties", "pruned"])
def test_density_equals_the_references(kind):
    w = _weights("normal" if kind == "pruned" else kind, seed=11)
    if kind == "pruned":
        w = np.array(rmasks.magnitude_prune(jnp.asarray(w), 0.3))
    want = rmasks.density(w)
    assert masks.density(torch.from_numpy(w)) == want
    assert masks.density(w) == want                 # an array too
    assert masks.density(torch.from_numpy(w).to(torch.bfloat16)) == want


@pytest.mark.parametrize("n_sel,m_group", [(2, 4), (1, 4), (3, 8)])
def test_nm_prune_ties_go_to_the_first(n_sel, m_group):
    w = _weights("ties", shape=(64, 16), seed=5)
    np.testing.assert_array_equal(
        masks.nm_prune(torch.from_numpy(w), n_sel, m_group).numpy(),
        np.asarray(rmasks.nm_prune(jnp.asarray(w), n_sel, m_group)))


@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_block_prune_keeps_tied_blocks(frac):
    w = _weights("flat", shape=(64, 64), seed=9)     # every block tied
    got = masks.block_prune(torch.from_numpy(w), 16, 16, frac).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(rmasks.block_prune(jnp.asarray(w), 16, 16, frac)))
    assert np.count_nonzero(got) == w.size          # all tie: all kept
