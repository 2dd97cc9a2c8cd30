"""Inputs the port's CUDA entries refuse and the reference computes,
pinned as deliberate divergences (ROADMAP.md, Queue 3).

N:M groups wider than 32 (``kernels/nm_spmm.py::MAX_M_GROUP``: the CUDA
kernels stage 32-column runs) are refused by both N:M entries with a
``ValueError`` before any launch, so the card never serves something else
in silence; the reference's kernels take any group.  On the CPU the port's
plain version serves them, equal to the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import nm_spmm as nm
from repro_torch.kernels import ops

N_SEL, M_GROUP = 4, 64                 # a 4:64 plan, past MAX_M_GROUP


def _operands(m, n, k):
    rng = np.random.default_rng(m + n + k)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(m, n)).astype(np.float32)
    return w, x, ops.compress_nm(torch.from_numpy(w), N_SEL, M_GROUP)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("m", [4, 64])
def test_nm_entries_refuse_groups_above_32(pipeline, m):
    assert M_GROUP > nm.MAX_M_GROUP
    w, x, c = _operands(m, 256, 64)
    with pytest.raises(ValueError, match=f"{N_SEL}:{M_GROUP}"):
        nm.select_entry(torch.from_numpy(x), c.values, c.indices, N_SEL,
                        M_GROUP, pipeline)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("m", [4, 64])
def test_cpu_plain_path_serves_groups_above_32_as_the_reference(pipeline, m):
    """The same payload as the reference's host compressor, and the product
    equal to the reference's Pallas kernel (interpret mode) to its own
    1e-5 (tests/test_kernels.py)."""
    n, k = 256, 64
    w, x, c = _operands(m, n, k)
    rc = rops.compress_nm(w, N_SEL, M_GROUP)
    assert np.array_equal(c.values.numpy(), np.asarray(rc.values))
    assert np.array_equal(c.indices.numpy(), np.asarray(rc.indices))
    y = ops.nm_spmm(torch.from_numpy(x), c, pipeline=pipeline)
    want = np.asarray(rops.nm_spmm(jnp.asarray(x), rc, bm=m, bn=128, bk=k,
                                   pipeline=pipeline))
    assert y.shape == (m, k)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
