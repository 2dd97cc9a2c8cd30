"""The port's mesh, sharding and partition layer against the reference's
(``repro.launch.mesh``, ``repro.models.sharding``,
``repro.models.partition``), as data.

* The mesh functions on this host's one device, and at other device
  counts (the port's ``mesh.devices`` stubbed) against the reference's
  own arithmetic, ``math.gcd`` and ``repro.runtime.fault.elastic_remesh``
  called directly; the production axis sets; a ``DeviceMesh`` only under
  a process group.
* ``param_specs``, ``cache_specs`` and ``batch_specs`` for every config
  of the registry, reduced and at full width, as shape-only trees
  (``jax.eval_shape`` on the reference's side, the meta device on the
  port's): each leaf's spec equals ``tuple(PartitionSpec)`` of the
  reference's, on both production axis sets, with ``replkv`` and
  ``padheads`` on and off (and ``sparseffn``'s payload leaves).
* ``logical_axis_rules``, ``spec`` and ``named_sharding``; ``shard`` is
  the identity outside a mesh and in a mesh of one device.
* ``serve.generate`` with ``mesh=None`` or a mesh of one device, and the
  CLI's ``--mesh``, serve the tokens of the mesh-less call.

A mesh whose ``model`` axis is larger than 1 raises in the port: pinned in
``test_torch_divergences.py``; data meshes of several devices serve and
train in ``test_torch_data_parallel.py``.
"""

import functools
import math
import socket
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from repro.configs import get_config as rget_config
from repro.configs.base import ShapeCfg
from repro.launch import mesh as rmesh
from repro.models import optflags as roptflags
from repro.models import partition as rpart
from repro.models import sharding as rsharding
from repro.models.transformer import Model as RModel
from repro.models.transformer import input_specs
from repro.runtime.fault import elastic_remesh as relastic_remesh
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import mesh
from repro_torch.launch import serve
from repro_torch.models import optflags, partition, sharding
from repro_torch.models.transformer import Model

ARCHS = list_archs()
#: both production axis sets, with their data axes
AXES = [({"data": 16, "model": 16}, ("data",)),
        ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))]
FLAG_SETS = [(), ("replkv",), ("padheads",), ("padheads", "replkv"),
             ("sparseffn", "replkv")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(m):
    return None if m is None else (m.axis_names, tuple(m.shape))


def _rshape(m):
    return None if m is None else (tuple(m.axis_names),
                                   tuple(m.devices.shape))


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def test_mesh_functions_on_one_device_equal_the_references():
    assert len(jax.devices()) == 1
    assert mesh.devices("cpu") == [torch.device("cpu")]
    for batch in range(0, 9):
        for model in (0, 1, 2):
            assert _shape(mesh.make_serve_mesh(batch, model, device="cpu")) \
                == _rshape(rmesh.make_serve_mesh(batch, model))
        assert _shape(mesh.degraded_serve_mesh(batch, 0, device="cpu")) == \
            _rshape(rmesh.degraded_serve_mesh(batch, 0))
    for data, model in ((1, 1), (2, 1), (1, 2)):
        assert _shape(mesh.make_small_mesh(data, model, device="cpu")) == \
            _rshape(rmesh.make_small_mesh(data, model))
    one = mesh.make_small_mesh(1, 1, device="cpu")
    assert one.size == 1 and one.devices.tolist() == [[torch.device("cpu")]]
    for lost in (1, 2):
        with pytest.raises(ValueError, match="nothing left"):
            rmesh.degraded_serve_mesh(4, lost)
        with pytest.raises(ValueError, match="nothing left"):
            mesh.degraded_serve_mesh(4, lost, device="cpu")


@pytest.mark.parametrize("n", [2, 3, 4, 8, 12, 16, 256])
def test_mesh_functions_at_other_device_counts(n, monkeypatch):
    """The reference's gcd and elastic re-mesh arithmetic, called
    directly."""
    monkeypatch.setattr(mesh, "devices",
                        lambda device="cuda": [torch.device("cpu")] * n)
    for batch in (0, 1, 2, 3, 4, 6, 8, 12, 32):
        for model in (0, 1, 2, 4, 16, 512):
            want = None
            if 1 <= model <= n:
                data = math.gcd(max(batch, 1), n // model)
                if data * model > 1:
                    want = (("data", "model"), (data, model))
            got = mesh.make_serve_mesh(batch, model, device="cpu")
            assert _shape(got) == want, (batch, model)
            if got is not None:
                assert got.devices.shape == got.shape
        for lost in range(0, n + 1):
            for model in (1, 2, 4):
                avail = n - lost
                if avail < 1 or avail < model:
                    with pytest.raises(ValueError):
                        mesh.degraded_serve_mesh(batch, lost, model,
                                                 device="cpu")
                    if avail >= 1:
                        with pytest.raises(ValueError):
                            relastic_remesh(avail, model)
                    continue
                data, model_ = relastic_remesh(avail, model)
                data = math.gcd(max(batch, 1), data)
                want = (("data", "model"), (data, model_)) \
                    if data * model_ > 1 else None
                assert _shape(mesh.degraded_serve_mesh(
                    batch, lost, model, device="cpu")) == want
    for data, model in ((1, 1), (2, 1), (2, 2), (n, 1), (n, 2)):
        want = (("data", "model"), (data, model)) \
            if data * model <= n else None
        assert _shape(mesh.make_small_mesh(data, model, device="cpu")) \
            == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_axes_equal_the_references(multi_pod):
    got = mesh.make_production_mesh(multi_pod=multi_pod)
    assert got.devices is None
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    # the reference's helpers read only axis_names and devices.shape
    stand_in = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape))
    assert (got.axis_names, got.shape) == (axes, shape)
    assert mesh.mesh_axis_sizes(got) == rmesh.mesh_axis_sizes(stand_in)
    assert mesh.data_axes_of(got) == rmesh.data_axes_of(stand_in)
    assert mesh.axis_map_for(got) == rmesh.axis_map_for(stand_in)
    assert got.size == math.prod(shape)


def test_a_device_mesh_only_under_a_process_group():
    one = mesh.make_small_mesh(1, 1, device="cpu")
    assert one.device_mesh() is None
    assert mesh.make_production_mesh().device_mesh() is None
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        dm = one.device_mesh()
        assert dm.mesh_dim_names == ("data", "model")
        assert tuple(dm.mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_entering_a_mesh_makes_it_current():
    one = mesh.make_small_mesh(1, 1, device="cpu")
    assert mesh.current() is None
    with one:
        assert mesh.current() is one
        with mesh.make_production_mesh() as prod:
            assert mesh.current() is prod
        assert mesh.current() is one
    assert mesh.current() is None


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_sharding_rules_equal_the_references(multi_pod):
    prod = mesh.make_production_mesh(multi_pod=multi_pod)
    amap = mesh.axis_map_for(prod)
    names = [("batch", None), ("batch", None, "vocab"),
             ("batch", "model", None), (None, "expert", "seq"), ()]
    for logical in names:
        assert sharding.spec(*logical) == tuple(rsharding.spec(*logical))
    with sharding.logical_axis_rules(amap), \
            rsharding.logical_axis_rules(amap):
        for logical in names:
            assert sharding.spec(*logical) == \
                tuple(rsharding.spec(*logical))
        ns = sharding.named_sharding(prod, "batch", None)
        assert ns.mesh is prod and ns.spec == tuple(rsharding.spec(
            "batch", None))
        x = torch.ones(2, 3)
        assert sharding.shard(x, "batch", None) is x     # outside a mesh
        with mesh.make_small_mesh(1, 1, device="cpu"):
            assert sharding.shard(x, "batch", None) is x
    assert sharding.spec("batch") == (None,)


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------

def _specs(tree):
    return jax.tree.map(tuple, tree,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str, reduced: bool, flags: tuple):
    rcfg, cfg = rget_config(arch), get_config(arch)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    with roptflags.optimizations(flags), optflags.optimizations(flags):
        want = jax.eval_shape(lambda: RModel(rcfg).init(jax.random.key(0)))
        got = Model(cfg).init(device="meta")
    return rcfg, want, got


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["+".join(f) or "none"
                                                  for f in FLAG_SETS])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, reduced, flags):
    shape_flags = tuple(f for f in flags if f != "replkv")
    rcfg, rtree, tree = _param_shapes(arch, reduced, shape_flags)
    assert tree["embed"].device.type == "meta"
    for axes, data_axes in AXES:
        for kv in (None, rcfg.n_kv_heads):
            with roptflags.optimizations(flags), \
                    optflags.optimizations(flags):
                want = _specs(rpart.param_specs(rtree, axes, data_axes,
                                                kv_heads=kv))
                got = partition.param_specs(tree, axes, data_axes,
                                            kv_heads=kv)
            assert got == want, (axes, kv)


#: (batch, max_len) of the decode caches: divisible by both data axis
#: sets or by neither, a context the model axis divides or not
CACHE_SHAPES = [(1, 1000), (32, 4096), (256, 2048), (3, 80)]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, reduced):
    rcfg, cfg = rget_config(arch), get_config(arch)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    for b, s in CACHE_SHAPES:
        rcache = jax.eval_shape(lambda: RModel(rcfg).init_cache(b, s))
        cache = Model(cfg).init_cache(b, s, device="meta")
        for axes, data_axes in AXES:
            assert partition.cache_specs(cache, axes, data_axes) == \
                _specs(rpart.cache_specs(rcache, axes, data_axes)), \
                (b, s, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_references(arch):
    """The reference's ``input_specs`` of train, prefill and decode cells
    at batches the data axes divide and do not."""
    rcfg = rget_config(arch)
    for kind in ("train", "prefill", "decode"):
        for b in (1, 16, 32, 48, 512):
            shape = ShapeCfg(f"{kind}-{b}", 128, b, kind)
            rbatch = input_specs(rcfg, shape)
            batch = jax.tree.map(
                lambda a: torch.empty(a.shape, device="meta"), rbatch)
            for axes, data_axes in AXES:
                assert partition.batch_specs(batch, axes, data_axes) == \
                    _specs(rpart.batch_specs(rbatch, axes, data_axes))


# ---------------------------------------------------------------------------
# mesh= through serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_model():
    cfg = get_config("chatglm3-6b").reduced()
    model = Model(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


def test_generate_with_mesh_none_equals_the_meshless_call(reduced_model):
    cfg, model, params = reduced_model
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 6)))
    want, _, _ = serve.generate(model, params, prompts, 4, 12, device="cpu")
    got, _, _ = serve.generate(model, params, prompts, 4, 12, mesh=None,
                               device="cpu")
    one = mesh.make_small_mesh(1, 1, device="cpu")
    got_one, _, _ = serve.generate(model, params, prompts, 4, 12, mesh=one,
                                   device="cpu")
    guarded, _, _, report = serve.generate(
        model, params, prompts, 4, 12, mesh=one, guarded=True, device="cpu")
    assert torch.equal(got, want) and torch.equal(got_one, want)
    assert torch.equal(guarded, want) and report.healthy


def test_the_cli_serves_the_same_tokens_with_mesh(capsys):
    argv = ["--arch", "chatglm3-6b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--gen", "4", "--device", "cpu"]
    serve.main(argv)
    plain = capsys.readouterr().out
    serve.main(argv + ["--mesh"])
    meshed = capsys.readouterr().out

    def sample(out):
        return [line for line in out.splitlines() if "sample out" in line]

    assert sample(plain) and sample(meshed) == sample(plain)
