"""The port's dry-run cells (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

* Per-device argument bytes against the reference's
  ``memory_analysis().argument_size_in_bytes`` on a (2, 2) mesh of forced
  host devices (a decode and a train cell of chatglm3-6b, granite's
  decode), and ``cell_applicable`` / the ``sparseffn`` skip for every
  arch x shape.  The reference's side runs in a subprocess: importing
  ``repro.launch.dryrun`` forces 512 host devices on every later JAX test
  of the process.
* ``input_specs`` against the reference's for every arch x shape.
* The trip-count counterpart: every family's reduced config at 4 units,
  cut to one and two and extrapolated, against a trace of all four, for
  each kind of cell: FLOPs, bytes and the per-device argument and output
  bytes exactly.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import _dryrun_cells as cells
from repro_torch.configs import SHAPES, ShapeCfg, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    yield from cells.one_thread()


# ---------------------------------------------------------------------------
# The reference's dry run, in a subprocess
# ---------------------------------------------------------------------------

ARG_CELLS = (("chatglm3-6b", "decode"), ("chatglm3-6b", "train"),
             ("granite-moe-3b-a800m", "decode"))
_REFERENCE_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.launch import dryrun as rd
from repro.configs import SHAPES, get_config, list_archs
from repro.configs.base import ShapeCfg
from repro.launch.mesh import axis_map_for
from repro.models.sharding import logical_axis_rules

class Proceeds(Exception):
    pass

def proceeds(**kw):
    raise Proceeds

out = {"args": {}, "skips": {}}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for arch, kind in json.loads(sys.argv[1]):
    cfg = get_config(arch).reduced()
    with mesh, logical_axis_rules(axis_map_for(mesh)):
        fn, args, shardings = rd.build_cell(cfg, ShapeCfg(kind, 64, 4, kind),
                                            mesh)
        compiled = jax.jit(fn, in_shardings=shardings).lower(*args).compile()
    out["args"][arch + "/" + kind] = \
        compiled.memory_analysis().argument_size_in_bytes
rd.make_production_mesh = proceeds
for arch in list_archs():
    for shape in SHAPES:
        for opts in ((), ("sparseffn",)):
            try:
                rec = rd.run_cell(arch, shape, False, opts=opts)
            except Proceeds:
                rec = "proceeds"
            out["skips"]["/".join((arch, shape) + opts)] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_dryrun():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT, json.dumps(ARG_CELLS)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,kind", ARG_CELLS)
def test_per_device_argument_bytes_equal_the_references(arch, kind,
                                                        reference_dryrun):
    cfg = get_config(arch).reduced()
    mesh = Mesh(("data", "model"), (2, 2))
    cell = dryrun.build_cell(cfg, ShapeCfg(kind, 64, 4, kind), mesh)
    got = dryrun.per_device_bytes(dryrun._pairs(cell.args, cell.specs),
                                  {"data": 2, "model": 2})
    assert got == reference_dryrun["args"][f"{arch}/{kind}"]


@pytest.mark.parametrize("arch", list_archs())
def test_cell_applicable_and_the_sparseffn_skip_equal_the_references(
        arch, reference_dryrun, monkeypatch):
    class Proceeds(Exception):
        pass

    def proceeds(**kw):
        raise Proceeds
    monkeypatch.setattr(dryrun, "make_production_mesh", proceeds)
    for shape in SHAPES:
        for opts in ((), ("sparseffn",)):
            try:
                rec = dryrun.run_cell(arch, shape, False, opts=opts)
            except Proceeds:
                rec = "proceeds"
            want = reference_dryrun["skips"]["/".join((arch, shape) + opts)]
            assert rec == want, (shape, opts)
            ok, _ = dryrun.cell_applicable(get_config(arch), SHAPES[shape])
            assert ok == (want == "proceeds" or "sparseffn" in want["reason"])


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_the_references(arch):
    """Every shape's inputs: the same keys, shapes and dtypes as the
    reference's ``ShapeDtypeStruct`` stand-ins, on the meta device."""
    import jax.numpy as jnp
    import torch
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget_config
    from repro.models.transformer import input_specs as rinput_specs
    from repro_torch.models.transformer import input_specs
    dtypes = {jnp.int32: torch.int32, jnp.float32: torch.float32}
    for name, shape in SHAPES.items():
        want = rinput_specs(rget_config(arch), RSHAPES[name])
        got = input_specs(get_config(arch), shape)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert t.dtype == dtypes[want[k].dtype.type]


# ---------------------------------------------------------------------------
# The depth extrapolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", cells.FAMILIES)
def test_extrapolation_equals_a_full_trace(arch, kind):
    _, cut = dryrun.repeat_units(get_config(arch).reduced())
    cfg = cut(4)
    shape = ShapeCfg(kind, 32, cells.B, kind)
    full = dryrun.step_cost(cfg, shape, cells.ONE, extrapolate=False)
    ext = dryrun.step_cost(cfg, shape, cells.ONE, extrapolate=True)
    assert (ext.cost.flops, ext.cost.bytes) == \
        (full.cost.flops, full.cost.bytes)
    assert full.cost.flops > 0
    assert (ext.argument_bytes, ext.output_bytes) == \
        (full.argument_bytes, full.output_bytes)
    assert ext.peak is None and full.peak >= full.argument_bytes
