"""The port's data-parallel serving and training over a mesh
(``repro_torch.launch.data_parallel``; ``serve.generate(mesh=)``,
``guarded_generate(mesh=)``, ``serve --mesh``, ``train(mesh=)`` and
``train.main`` on a host of several devices) against the reference's, on
reduced chatglm3-6b at fp32.

The reference runs once, in a subprocess with four forced host devices
(``tests/_data_parallel_reference.py``): ``serve.generate`` dense, bitmap
and 2:4 on ``make_serve_mesh(8)`` (data 4) with equal prompts and with
ragged prompts and EOS, ``guarded_generate`` healthy, with a flipped
payload bit and with a NaN payload, and three training steps on
``make_small_mesh(2, 1)`` with and without ``grad_compress``.  On this
JAX (0.9, whose ``make_mesh`` gives Explicit axes) the reference refuses
every one of them on its mesh: serving with a ``ShardingTypeError`` at the
embedding's gather of the batch sharded over ``data``, training with a
``ValueError`` from ``with_sharding_constraint``.  That is pinned here
(:func:`test_the_references_sharded_runs_fail_on_this_jax`), and the port's
sharded runs are held to the reference's unsharded run of the same calls,
which its sharded run would compute: tokens equal, fp32 logits within
1e-5, ``HealthReport.stable_dict()`` equal, losses within 1e-5 and the
final params within 1e-4 of each leaf's largest magnitude (one element a
leaf within 1e-3: see the training test).

The port's meshes repeat the CPU device (four replicas on one device
stand in for four devices, as the forced host devices do); the mesh
functions that count devices see four through a stub of
``mesh.devices``.  Also here: each replica's own payload and model object,
a flipped bit on one replica demoting the role on all, every replica's
params bit for bit equal after every step, a checkpoint restored onto
every replica, ``degraded_serve_mesh`` serving and ``shard`` in a mesh.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models.transformer import Model as RModel
from repro_torch import exec as texec
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import compiled, data_parallel, mesh, serve, train
from repro_torch.models import layers as L
from repro_torch.models import sharding
from repro_torch.models.transformer import Model
from repro_torch.runtime import guard, inject

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _data_parallel_reference as ref  # noqa: E402

CPU = torch.device("cpu")
KINDS = ("dense", "bitmap", "nm")


@pytest.fixture(scope="module", autouse=True)
def fp32_one_thread():
    """fp32 compute, and one intra-op thread for this module's many small
    ops (the suite runs several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs (arrays, and ``meta``: plans, reports and the
    errors of its sharded attempts)."""
    path = tmp_path_factory.mktemp("dp") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_data_parallel_reference.py"),
         str(path)], capture_output=True, text=True, env=env, timeout=600,
        cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as data:
        out = {k: data[k] for k in data.files}
    out["meta"] = json.loads(str(out["meta"]))
    return out


def cpu_mesh(data: int, model: int = 1) -> mesh.Mesh:
    """A (data, model) mesh over the CPU device repeated."""
    return mesh.Mesh(("data", "model"), (data, model),
                     mesh.grid([CPU] * (data * model), (data, model)))


@pytest.fixture(scope="module")
def served(reference):
    """The port's dense, bitmap and 2:4 models over the reference's
    weights and plans, each with the tree it serves."""
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    params = params_from_numpy(
        jax.tree.map(np.asarray, RModel(rcfg).init(jax.random.key(0))),
        "cpu")
    out = {"dense": (Model(cfg), params)}
    for kind in ("bitmap", "nm"):
        plan = texec.ExecPlan.from_json(reference["meta"]["plans"][kind])
        out[kind] = serve.compressed_model(cfg, params, plan, device="cpu")
    return cfg, out


def _prompts(cfg, ragged=False):
    return torch.from_numpy(ref.ragged(cfg.vocab) if ragged
                            else ref.prompts(cfg.vocab))


# ---------------------------------------------------------------------------
# the reference's own sharded runs
# ---------------------------------------------------------------------------

def test_the_references_sharded_runs_fail_on_this_jax(reference):
    """Pinned: the reference cannot run any of these on its mesh here, so
    its unsharded run is what the port's sharded run is held to."""
    errors = reference["meta"]["sharded_errors"]
    serving = [f"{k}/{run}" for k in KINDS
               for run in ("generate", "logits", "ragged_eos")] + \
        [f"guarded/{s}" for s in ("healthy", "bitflip", "nan_payload")]
    assert sorted(errors) == sorted(serving + ["train/0", "train/1"])
    for name in serving:
        assert errors[name].startswith("ShardingTypeError: ") and \
            "@data" in errors[name], errors[name]
    for name in ("train/0", "train/1"):
        assert errors[name].startswith("ValueError: ") and \
            "Auto axes" in errors[name], errors[name]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_generate_over_a_mesh_equals_the_reference(kind, served, reference):
    cfg, models = served
    model, params = models[kind]
    four = cpu_mesh(4)
    prompts = _prompts(cfg)
    toks, _, _ = serve.generate(model, params, prompts, ref.GEN,
                                ref.PLEN + ref.GEN, mesh=four, device="cpu")
    assert toks.dtype == torch.int32 and toks.device == CPU
    np.testing.assert_array_equal(toks.numpy(), reference[f"{kind}/tokens"])

    # the prefill's last logits and every decode step's, replica by replica
    reps = data_parallel.replicate_model(model, params, four)
    last = reps.prefill(reps.params, prompts, ref.PLEN + ref.GEN)[0][:, -1]
    greedy, steps = compiled.greedy(reps.step(compiled.CompiledStep), reps,
                                    reps.params, prompts, ref.GEN)
    np.testing.assert_array_equal(greedy.numpy(),
                                  reference[f"{kind}/tokens"])
    got = torch.stack([last] + steps).numpy()
    np.testing.assert_allclose(got, reference[f"{kind}/logits"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_ragged_prompts_with_eos_over_a_mesh_equal_the_reference(
        kind, served, reference):
    cfg, models = served
    model, params = models[kind]
    eos = int(reference[f"{kind}/eos_id"])
    toks, _, _ = serve.generate(model, params, _prompts(cfg, ragged=True),
                                ref.GEN, ref.PLEN + ref.GEN,
                                mesh=cpu_mesh(4), prompt_pad_id=0, eos_id=eos,
                                pad_id=-3, device="cpu")
    want = reference[f"{kind}/ragged_eos"]
    np.testing.assert_array_equal(toks.numpy(), want)
    assert (want[0, 2:] == -3).all()           # row 0 ended on its EOS


def _guarded(model, params, prompts, **kw):
    toks, rep = guard.guarded_generate(model, params, prompts, ref.GEN,
                                       device="cpu", **kw)
    return toks.numpy(), rep.stable_dict()


@pytest.mark.parametrize("scenario", ["healthy", "bitflip", "nan_payload"])
def test_guarded_generate_over_a_mesh_equals_the_reference(
        scenario, served, reference):
    cfg, models = served
    cm, pruned = models["bitmap"]
    role = reference["meta"]["role"]
    model, kw = {
        "healthy": (cm, {}),
        "bitflip": (texec.CompressedModel(
            cm.model, inject.bitflip_payload(cm.store, role)), {}),
        "nan_payload": (texec.CompressedModel(
            cm.model, inject.poison_payload_nan(cm.store, role)),
            {"verify": False}),
    }[scenario]
    toks, rep = _guarded(model, pruned, _prompts(cfg), mesh=cpu_mesh(4),
                         **kw)
    np.testing.assert_array_equal(toks, reference[f"guarded/{scenario}"])
    assert rep == reference["meta"]["reports"][scenario]
    # every recovery serves the healthy tokens
    np.testing.assert_array_equal(toks, reference["bitmap/tokens"])


def test_a_bit_flipped_on_one_replica_demotes_the_role_on_all(served,
                                                              reference):
    """Replica 2's payload alone is corrupt: verify finds it there, and the
    role is served dense on every replica, as the reference serves a
    store corrupt on its one copy."""
    cfg, models = served
    cm, pruned = models["bitmap"]
    role = reference["meta"]["role"]
    reps = data_parallel.replicate_model(cm, pruned, cpu_mesh(4))
    healthy = reps.models[2].store
    reps.models[2] = texec.CompressedModel(
        reps.models[2].model, inject.bitflip_payload(healthy, role))
    assert [m.store.verify() for m in reps.models[:2]] == \
        [healthy.verify()] * 2
    toks, rep = _guarded(reps, None, _prompts(cfg), mesh=cpu_mesh(4))
    assert rep == reference["meta"]["reports"]["bitflip"]
    np.testing.assert_array_equal(toks, reference["guarded/bitflip"])


def test_each_replica_has_its_own_payload_and_model(served):
    cfg, models = served
    cm, pruned = models["bitmap"]
    reps = data_parallel.replicate_model(cm, pruned, cpu_mesh(3))
    assert len({id(m) for m in reps.models}) == 3
    assert len({id(m.model) for m in reps.models}) == 3
    for key in ("embed",):
        ptrs = [reps.params[i][key].data_ptr() for i in range(3)]
        # the first replica takes the caller's tensor, the others clones
        assert ptrs[0] == pruned[key].data_ptr() and len(set(ptrs)) == 3
    blocks = [m.store.entries[next(iter(m.store.entries))].data.blocks
              for m in reps.models]
    assert len({b.data_ptr() for b in blocks}) == 3
    assert all(torch.equal(b, blocks[0]) for b in blocks)
    assert reps.models[1].store.plan == cm.store.plan
    # a replica's graphs are keyed on its own model object
    compiled.graphs(reps.models[0])["k"] = "graph"
    assert compiled.graphs(reps.models[1]) == {}


def test_rows_split_and_gather_in_mesh_order():
    x = torch.arange(24).reshape(8, 3)
    parts = data_parallel.split_rows(x, 4)
    assert [p[:, 0].tolist() for p in parts] == [[0, 3], [6, 9], [12, 15],
                                                 [18, 21]]
    assert torch.equal(data_parallel.gather(parts[::-1][::-1], CPU), x)
    with pytest.raises(ValueError, match="does not split"):
        data_parallel.split_rows(x, 3)
    pod = mesh.Mesh(("pod", "data", "model"), (2, 2, 1),
                    mesh.grid([torch.device("cpu", i) for i in range(4)],
                              (2, 2, 1)))
    assert [d.index for d in data_parallel.data_devices(pod)] == [0, 1, 2, 3]


def test_degraded_serve_mesh_serves(served, reference, monkeypatch):
    """Four devices, two lost: (data 2, model 1) over the survivors serves
    the tokens of the full mesh."""
    cfg, models = served
    model, params = models["nm"]
    monkeypatch.setattr(mesh, "devices",
                        lambda device="cuda": [CPU] * 4)
    two = mesh.degraded_serve_mesh(ref.BATCH, lost=2, device="cpu")
    assert two.shape == (2, 1)
    toks, _, _ = serve.generate(model, params, _prompts(cfg), ref.GEN,
                                ref.PLEN + ref.GEN, mesh=two, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), reference["nm/tokens"])


def test_serve_cli_mesh_serves_over_every_device(monkeypatch, capsys):
    argv = ["--arch", "chatglm3-6b", "--reduced", "--batch", "4",
            "--prompt-len", "6", "--gen", "3", "--device", "cpu"]
    serve.main(argv)
    plain = capsys.readouterr().out
    monkeypatch.setattr(mesh, "devices",
                        lambda device="cuda": [CPU] * 4)
    serve.main(argv + ["--mesh"])
    meshed = capsys.readouterr().out
    assert "batch=4 devices=1 on cpu" in plain
    assert "batch=4 devices=4 on cpu" in meshed
    assert all(line.count("tok/s/dev") == 1 for line in meshed.splitlines()
               if line.startswith(("  prefill", "  decode")))

    def sample(out):
        return [line for line in out.splitlines() if "sample out" in line]
    assert sample(plain) and sample(meshed) == sample(plain)


def test_serve_cli_mixer_with_mesh_divides_its_rate(monkeypatch, capsys):
    """``--mixer --mesh``: the stream is not sharded (as the reference's
    is not), and the decode rate is divided by the devices."""
    monkeypatch.setattr(mesh, "devices",
                        lambda device="cuda": [CPU] * 2)
    serve.main(["--arch", "chatglm3-6b", "--reduced", "--batch", "2",
                "--prompt-len", "6", "--gen", "2", "--mixer", "--mesh",
                "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("slots=2 requests=2 on cpu devices=2")
    (decode,) = [line for line in out if line.startswith("  decode")]
    rate = float(decode.split("(")[1].split(" tok/s,")[0])
    per_dev = float(decode.split("tok/s, ")[1].split(" tok/s/dev")[0])
    assert per_dev == pytest.approx(rate / 2, abs=0.06)


def test_shard_is_the_identity_in_a_data_only_mesh():
    x = torch.ones(4, 2)
    four = cpu_mesh(4)
    with four, sharding.logical_axis_rules(mesh.axis_map_for(four)):
        assert sharding.shard(x, "batch", None) is x
        assert sharding.shard(x, "batch", "model") is x
        assert sharding.shard(x, None, "vocab") is x


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _args(**kw):
    argv = ["--arch", "chatglm3-6b", "--device", "cpu"]
    for k, v in kw.items():
        flag = f"--{k.replace('_', '-')}"
        argv += [flag] if v is True else [] if v is False else [flag, str(v)]
    return train.parse_args(argv)


def _train(served, mesh_, **kw):
    cfg, models = served
    args = _args(steps=ref.TRAIN_STEPS, batch=ref.TRAIN_BATCH,
                 seq=ref.TRAIN_SEQ, lr=ref.LR, **kw)
    return train.train(cfg, models["dense"][1], args, device="cpu",
                       mesh=mesh_)


@pytest.mark.parametrize("compress", [False, True])
def test_train_over_a_mesh_equals_the_reference(compress, served, reference,
                                                capsys):
    run = _train(served, cpu_mesh(2), grad_compress=compress)
    key = f"train/{int(compress)}"
    np.testing.assert_allclose(run.losses, reference[f"{key}/losses"],
                               rtol=0, atol=1e-5)
    leaves = tree.leaves(run.params)
    assert len(leaves) == len([k for k in reference if
                               k.startswith(f"{key}/leaf_")])
    for i, leaf in enumerate(leaves):
        # within 1e-4 of the leaf's largest magnitude, but for at most one
        # element a leaf, within 1e-3: AdamW divides a gradient near zero
        # by its own root mean square, and int8 compression rounds one at
        # a step's boundary, so a last-bit difference in such a gradient
        # moves its element by a share of the learning rate.  The port's
        # one-device run shows the same single elements against the
        # reference (2.3e-4 in the w_down leaf here, without compression).
        want = reference[f"{key}/leaf_{i}"]
        tol = 1e-4 * float(np.abs(want).max())
        err = np.abs(leaf.numpy() - want)
        assert (err > tol).sum() <= 1 and err.max() <= 10 * tol, \
            (i, int((err > tol).sum()), float(err.max()) / tol)
    assert len(run.replicas) == 2 and \
        data_parallel.params_equal(run.replicas)
    assert (run.opt_state.err is not None) == compress
    capsys.readouterr()


def test_the_replicas_stay_bit_identical_after_every_step(served,
                                                          monkeypatch):
    """The loop checks the replicas after each update: one that differs
    raises."""
    seen = []
    real = data_parallel.params_equal

    def spy(replicas):
        seen.append(len(replicas))
        return real(replicas)
    monkeypatch.setattr(data_parallel, "params_equal", spy)
    _train(served, cpu_mesh(4))
    assert seen == [4] * ref.TRAIN_STEPS
    monkeypatch.setattr(data_parallel, "params_equal", lambda r: False)
    with pytest.raises(AssertionError, match="replicas' params differ"):
        _train(served, cpu_mesh(2))


def test_a_checkpoint_is_restored_onto_every_replica(served, tmp_path,
                                                     capsys):
    """Replica 0's state is saved; ``--resume`` puts it on every replica,
    and the resumed run's losses are the one-device resumed run's."""
    cfg, models = served
    params = models["dense"][1]
    base = dict(batch=ref.TRAIN_BATCH, seq=ref.TRAIN_SEQ, lr=ref.LR,
                ckpt_every=2)
    first = train.train(cfg, params, _args(steps=2, ckpt_dir=tmp_path / "a",
                                           **base),
                        device="cpu", mesh=cpu_mesh(2))
    saved, _ = ckpt.restore(str(tmp_path / "a"), {"params": first.params,
                                                  "opt": first.opt_state})
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(saved["params"]), tree.leaves(first.replicas[1])))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    resumed = train.train(cfg, params, _args(
        steps=4, resume=True, ckpt_dir=tmp_path / "a", **base), device="cpu",
        mesh=cpu_mesh(2))
    alone = train.train(cfg, params, _args(
        steps=4, resume=True, ckpt_dir=tmp_path / "b", **base), device="cpu")
    assert capsys.readouterr().out.count("[resume] step 2") == 2
    assert resumed.pstate.step == alone.pstate.step == 4
    assert len(resumed.losses) == len(alone.losses) == 2
    np.testing.assert_allclose(resumed.losses, alone.losses, rtol=0,
                               atol=1e-5)
    assert data_parallel.params_equal(resumed.replicas)


def test_train_main_trains_on_two_devices(monkeypatch, capsys):
    """``main`` on a host of several devices trains on the reference's
    (data 2, model 1) mesh."""
    argv = ["--arch", "chatglm3-6b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    alone = train.main(argv)
    monkeypatch.setattr(mesh, "devices",
                        lambda device="cuda": [CPU] * 3)
    meshed = train.main(argv)
    capsys.readouterr()
    assert len(alone.replicas) == 1 and len(meshed.replicas) == 2
    np.testing.assert_allclose(meshed.losses, alone.losses, rtol=0,
                               atol=1e-5)
