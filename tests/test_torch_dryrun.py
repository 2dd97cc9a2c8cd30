"""The port's dry run and its cost counter (``repro_torch.launch.dryrun``,
``repro_torch.launch.op_cost``) against the reference's
(``repro.launch.dryrun``, ``repro.launch.hlo_cost``).

* Trip counts: a loop of 8 ``tanh(c @ w)`` counts every iteration, as
  the reference's ``hlo_cost`` counts its ``lax.scan`` (the counterpart
  of ``tests/test_optflags.py::test_hlo_cost_trip_counts``).
* Bytes rule by rule, fp32, on single-op functions: each equals the
  reference's ``hlo_cost`` of the ``jnp`` counterpart; what a fused dot
  reads; live bytes.
* FLOPs of every family's prefill and decode cell at reduced width
  against ``hlo_cost.analyze_compiled`` of the reference's jitted step,
  the port's attention in chunks of 16 so that S 64 spans 4 x 4 chunk
  pairs (train: ``test_torch_dryrun_train.py``; the depth extrapolation,
  per-device bytes and the skips: ``test_torch_dryrun_cells.py``).
* Dense decode bytes against a count written out from the config.
* The CLI, and a failed cell recorded as failed.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

import _dryrun_cells as cells
from repro.launch import hlo_cost
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, op_cost
from repro_torch.models.transformer import Model

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the keys of the reference's ``run_cell`` record of a compiled cell
#: (``src/repro/launch/dryrun.py``, ``record.update`` in ``run_cell``)
REFERENCE_KEYS = {"arch", "shape", "mesh", "ok", "opts", "lower_s",
                  "compile_s", "flops", "hlo_bytes", "collectives",
                  "coll_bytes", "xla_flops_raw", "xla_bytes_raw", "devices",
                  "memory_analysis", "params_count", "active_params"}
#: where the two express an op differently, with why (at most 1 % apart)
DIFFERENT = {
    ("recurrentgemma-2b", "decode"):
        "conv_step: the reference einsums the K = 4 conv taps (a dot), the "
        "port multiplies them and sums in fp32 (one rounding, as the dot)",
    ("mamba2-780m", "decode"): "conv_step, as recurrentgemma-2b's",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    yield from cells.one_thread()


@pytest.fixture
def small_chunks(monkeypatch):
    return cells.small_chunks(monkeypatch)


# ---------------------------------------------------------------------------
# Trip counts and the rules
# ---------------------------------------------------------------------------

def test_trip_counts_count_every_iteration():
    def scanned(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        c, _ = lax.scan(body, x, None, length=8)
        return c

    x = jnp.zeros((64, 64))
    want = hlo_cost.analyze_compiled(
        jax.jit(scanned).lower(x, x).compile())["flops"]

    def loop(c, w):
        for _ in range(8):
            c = torch.tanh(c @ w)
        return c

    t = torch.zeros((64, 64), device="meta")
    _, counted = op_cost.count(loop, t, t)
    assert counted.cost.flops == 8 * 2 * 64 ** 3 == want


def _z(*shape):
    return jnp.zeros(shape, jnp.float32)


def _t(*shape):
    return torch.zeros(shape)


#: (reference function, its inputs, the port's, its inputs), fp32
RULES = {
    "dot": (lambda a, b: a @ b, (_z(32, 48), _z(48, 16)),
            lambda a, b: a @ b, (_t(32, 48), _t(48, 16))),
    "dynamic_update_slice_copy": (
        lambda x, u: lax.dynamic_update_slice(x, u, (3, 0)),
        (_z(64, 32), _z(4, 32)),
        lambda x, u: x[3:7].copy_(u), (_t(64, 32), _t(4, 32))),
    "dynamic_update_slice_index_put": (
        lambda x, u: lax.dynamic_update_slice(x, u, (3, 0)),
        (_z(64, 32), _z(4, 32)),
        lambda x, u: x.index_put_((torch.arange(3, 7),), u),
        (_t(64, 32), _t(4, 32))),
    "take": (lambda x, i: jnp.take(x, i, axis=0),
             (_z(64, 32), jnp.zeros((8,), jnp.int32)),
             lambda x, i: x[i],
             (_t(64, 32), torch.zeros(8, dtype=torch.int32))),
    "reduce": (lambda x: jnp.sum(x, axis=1), (_z(64, 32),),
               lambda x: x.sum(1), (_t(64, 32),)),
    "concatenate": (lambda a, b: jnp.concatenate([a, b], 0),
                    (_z(16, 32), _z(8, 32)),
                    lambda a, b: torch.cat([a, b], 0),
                    (_t(16, 32), _t(8, 32))),
    "sort": (lambda x: jnp.sort(x, axis=-1), (_z(16, 32),),
             lambda x: torch.sort(x, dim=-1).values, (_t(16, 32),)),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_bytes_rule_by_rule_equal_the_references(rule):
    rfn, rargs, fn, args = RULES[rule]
    want = hlo_cost.analyze_compiled(jax.jit(rfn).lower(*rargs).compile())
    _, counted = op_cost.count(fn, *args)
    assert counted.cost.bytes == want["bytes"] > 0
    assert counted.cost.flops == want["flops"]


def test_views_and_elementwise_ops_are_free():
    x = _t(16, 32)
    _, counted = op_cost.count(
        lambda x: torch.tanh(x.t() * 2.0 + 1.0).reshape(-1)[:8], x)
    assert counted.cost.bytes == counted.cost.flops == 0
    assert counted.cost.coll_bytes == counted.cost.coll_count == 0


def test_a_dot_reads_the_distinct_bytes_a_cast_or_repeat_was_made_from():
    """A bf16 cast of an fp32 weight reads the fp32 weight; a GQA-repeated
    cache (expand + copy) reads the cache once."""
    w = _t(48, 16)
    x = _t(4, 48).bfloat16()
    _, cast = op_cost.count(lambda x, w: x @ w.to(torch.bfloat16), x, w)
    assert cast.cost.bytes == 4 * 48 * 2 + 48 * 16 * 4 + 4 * 16 * 2
    k = _t(2, 8, 2, 4)                        # (B, S, Hkv, D), 2 groups of 3
    q = _t(2, 6, 4)

    def scores(q, k):
        rep = k[:, :, :, None].expand(2, 8, 2, 3, 4).reshape(2, 8, 6, 4)
        return torch.einsum("bhd,bshd->bhs", q, rep)
    _, rep = op_cost.count(scores, q, k)
    assert rep.cost.bytes == q.numel() * 4 + k.numel() * 4 + 2 * 6 * 8 * 4


def test_live_bytes_count_a_storage_once_and_free_it():
    a = _t(256)

    def step(a):
        b = a * 2.0                                   # 1 KiB
        views = [b[:128], b[128:], b.reshape(16, 16)]  # no new storage
        c = torch.cat([views[0], views[1]])          # 1 KiB
        del b, views
        return c + 1.0                                # 1 KiB, b freed
    with op_cost.OpCost() as oc:
        oc.track(a)
        out = step(a)
    assert oc.peak == 3 * 1024
    assert oc.live == 2 * 1024           # a and the result; c died
    del out


# ---------------------------------------------------------------------------
# The model's FLOPs and bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", cells.FAMILIES)
def test_flops_equal_the_references(arch, kind, small_chunks):
    cells.assert_flops_parity(arch, kind, small_chunks, DIFFERENT)


def test_dense_decode_bytes_against_the_configs_extents():
    """Every weight once (fp32: the bf16 casts fuse into the dots), the K
    and V caches read once and the step's writes into them, the embedding
    row and the logits (the head's bf16 product)."""
    cfg = get_config("chatglm3-6b").reduced()
    b, s = 4, 1024

    def named(tree, name=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from named(v, k)
        else:
            yield name, tree
    params = Model(cfg).init(device="meta")
    weights = sum(4 * t.numel() for name, t in named(params)
                  if name not in ("ln1", "ln2", "final_norm"))
    kv = cfg.n_layers * b * cfg.n_kv_heads * cfg.head_dim * 2   # bf16
    want = (weights + 2 * kv * s + 2 * kv + 4 * b * cfg.d_model
            + 2 * b * cfg.vocab)
    got = cells.port_cost("chatglm3-6b", "decode", b, s).bytes
    assert abs(got - want) <= 0.1 * want, (got, want)


# ---------------------------------------------------------------------------
# The CLI and failures
# ---------------------------------------------------------------------------

def test_the_cli_writes_a_record_with_the_references_keys(tmp_path):
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "chatglm3-6b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(
        (tmp_path / "chatglm3-6b__decode_32k__single.json").read_text())
    assert REFERENCE_KEYS <= set(rec)
    assert rec["ok"] and rec["devices"] == 256
    assert rec["compile_s"] is rec["xla_flops_raw"] is None
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 < mem["output_size_in_bytes"]
    assert rec["step_flops"] > 0 and "failures=0" in run.stdout


def test_a_failed_cell_is_recorded_and_fails_the_sweep(monkeypatch, tmp_path,
                                                      capsys):
    def broken(*a, **kw):
        raise RuntimeError("no such op on meta")
    monkeypatch.setattr(dryrun, "step_cost", broken)
    rec = dryrun.run_cell("mamba2-780m", "decode_32k", False)
    assert rec["ok"] is False
    assert rec["error"] == "RuntimeError: no such op on meta"
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert ex.value.code == 1
    assert "failures=1" in capsys.readouterr().out
    rec = json.loads(
        (tmp_path / "mamba2-780m__decode_32k__single.json").read_text())
    assert rec["ok"] is False
