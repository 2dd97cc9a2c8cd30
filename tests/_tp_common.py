"""What the tensor-parallel test modules share
(``test_torch_tensor_parallel.py`` on reduced chatglm3-6b,
``test_torch_tensor_parallel_moe.py`` on reduced granite-moe-3b-a800m):
the meshes over the CPU device, the reference subprocess's environment,
tree walks, and the groups' greedy logits and the bf16 spread check."""

import math
import os
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.launch import compiled, mesh
from repro_torch.models import layers as L

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
KINDS = ("dense", "bitmap", "nm")
MESHES = ((1, 2), (1, 4), (2, 2))


@pytest.fixture(scope="module", autouse=True)
def fp32_one_thread():
    """fp32 compute, and one intra-op thread for the module's many small
    ops (the suite runs several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield
    torch.set_num_threads(n)


def reference_env() -> dict:
    """The environment of a reference subprocess: JAX on the CPU with four
    forced host devices, the reference's sources on the path."""
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                            os.environ.get("PYTHONPATH",
                                                           "")]))


def cpu_mesh(data: int, model: int) -> mesh.Mesh:
    """A (data, model) mesh over the CPU device repeated."""
    return mesh.Mesh(("data", "model"), (data, model),
                     mesh.grid([CPU] * (data * model), (data, model)))


def walk(tree, path=()):
    """(path, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    else:
        yield path, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def greedy_logits(groups, prompts, gen: int, max_len: int):
    """The groups' greedy tokens (eager decode) and the prefill's last
    logits stacked with every decode step's: (gen, B, V), fp32."""
    last = groups.prefill(groups.params, prompts, max_len)[0][:, -1]
    toks, steps = compiled.greedy(groups.step(compiled.CompiledStep),
                                  groups, groups.params, prompts, gen)
    return toks, torch.stack([last] + steps).float().numpy()


def assert_within_spread(got, toks, want, rtoks, bound: float) -> None:
    """bf16 logits ``got`` (and tokens ``toks``) against the reference's
    ``want`` / ``rtoks``: a row's logits within ``bound`` while its
    tokens agree, its tokens equal at every step whose top-2 margin in
    the reference exceeds twice the bound, and at least half the rows'
    steps compared."""
    alive = np.ones(rtoks.shape[0], bool)
    compared = 0
    for i in range(rtoks.shape[1]):
        err = np.abs(got[i] - want[i]).max(axis=-1)
        assert (err[alive] <= bound).all(), (i, err, bound)
        compared += alive.sum()
        top2 = np.sort(want[i], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * bound
        same = toks[:, i].numpy() == rtoks[:, i]
        assert same[alive & sure].all(), (i, same, sure)
        alive &= same
    assert compared >= rtoks.shape[0] * rtoks.shape[1] // 2
