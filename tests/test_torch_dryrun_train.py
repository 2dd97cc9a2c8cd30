"""FLOPs of every family's train cell (``Model.loss``, its gradients
under remat, ``adamw.apply``) at reduced width: the port's dry run
(``repro_torch.launch.dryrun``) against ``hlo_cost.analyze_compiled`` of
the reference's jitted step (``jax.value_and_grad(model.loss)`` and its
AdamW), the port's attention in chunks of 16 so that S 64 spans 4 x 4
chunk pairs.  The remat recompute counts in both.  Prefill and decode:
``test_torch_dryrun.py``.
"""

import pytest

import _dryrun_cells as cells

#: where the two express an op differently, with why (at most 1 % apart)
DIFFERENT = {
    ("granite-moe-3b-a800m", "train"):
        "the backward of the MoE dispatch einsum gtke,gtkc,gtk->gtec: JAX's "
        "transpose contracts the top-k axis with a dot, autograd multiplies "
        "and sums",
    ("mamba2-780m", "train"):
        "the backward of the SSD einsum bln,blh,bhpn->blhp: JAX's transpose "
        "contracts with dots where autograd multiplies and sums",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    yield from cells.one_thread()


@pytest.fixture
def small_chunks(monkeypatch):
    return cells.small_chunks(monkeypatch)


@pytest.mark.parametrize("arch", cells.FAMILIES)
def test_train_flops_equal_the_references(arch, small_chunks):
    cells.assert_flops_parity(arch, "train", small_chunks, DIFFERENT)
