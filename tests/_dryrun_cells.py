"""Shared by the ``test_torch_dryrun*.py`` files: one reduced cell's cost
in each package, and the port's attention in small chunks.

``reference_cost`` is ``hlo_cost.analyze_compiled`` of the reference's
jitted step (the steps of the reference dry run's ``build_cell``), built
here because importing ``repro.launch.dryrun`` forces 512 host devices
on every later JAX test of the process.
"""

import jax
import torch

from repro.configs import get_config as rget_config
from repro.configs.base import ShapeCfg as RShapeCfg
from repro.launch import hlo_cost
from repro.models.transformer import Model as RModel
from repro.models.transformer import input_specs as rinput_specs
from repro.optim import adamw as radamw
from repro_torch.configs import ShapeCfg, get_config
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as attn

FAMILIES = ("chatglm3-6b", "gemma3-27b", "whisper-tiny",
            "granite-moe-3b-a800m", "recurrentgemma-2b", "mamba2-780m")
ONE = Mesh(("data", "model"), (1, 1))
B, S, CHUNK = 2, 64, 16


def one_thread():
    """A module fixture's body: one intra-op thread while the module runs
    (the suite runs several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_chunks(monkeypatch) -> list:
    """The port's attention in chunks of ``CHUNK``, so that S 64 spans 4 x
    4 chunk pairs; returns the q-chunk counts of the calls.  The FLOPs do
    not depend on the chunking: every pair is computed and none padded."""
    calls = []
    whole = attn.chunked_attention

    def chunked(q, k, v, **kw):
        calls.append(q.shape[1] // CHUNK)
        return whole(q, k, v, q_chunk=CHUNK, kv_chunk=CHUNK, **kw)
    monkeypatch.setattr(attn, "chunked_attention", chunked)
    return calls


def reference_cost(arch: str, kind: str, b: int = B, s: int = S) -> dict:
    """The reference's terms of a reduced cell."""
    cfg = rget_config(arch).reduced()
    model = RModel(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    inputs = rinput_specs(cfg, RShapeCfg(kind, s, b, kind))
    if kind == "train":
        opt_cfg = radamw.AdamWConfig()
        opt = jax.eval_shape(lambda: radamw.init(params, opt_cfg))

        def fn(params, opt, batch):
            loss, grads = jax.value_and_grad(model.loss)(params, batch)
            return loss, radamw.apply(params, grads, opt, opt_cfg)
        args = (params, opt, inputs)
    elif kind == "prefill":
        def fn(params, batch):
            return model.hidden_states(params, batch["tokens"],
                                       batch.get("enc_frames"), remat=False)
        args = (params, inputs)
    else:
        cache = jax.eval_shape(lambda: model.init_cache(b, s))

        def fn(params, cache, batch):
            return model.decode_step(params, cache, batch["tokens"],
                                     batch["pos"])
        args = (params, cache, inputs)
    return hlo_cost.analyze_compiled(jax.jit(fn).lower(*args).compile())


def port_cost(arch: str, kind: str, b: int = B, s: int = S
              ) -> op_cost.Cost:
    """The port's dry-run terms of the same cell, traced at full depth."""
    cfg = get_config(arch).reduced()
    return dryrun.step_cost(cfg, ShapeCfg(kind, s, b, kind), ONE,
                            extrapolate=False).cost


def assert_flops_parity(arch: str, kind: str, calls: list,
                        different: dict) -> None:
    """The port's FLOPs equal the reference's, or lie within 1 % where
    ``different`` names why the two express an op differently."""
    want = reference_cost(arch, kind)["flops"]
    got = port_cost(arch, kind).flops
    if kind != "decode" and arch != "mamba2-780m":
        assert calls and max(calls) >= 4, calls
    if (arch, kind) in different:
        assert got != want
        assert abs(got - want) <= 0.01 * want, (got, want)
    else:
        assert got == want
