"""The compiled decode step (``repro_torch.launch.compiled``) on the CPU.

On the CPU the compiled step is the eager step; what the graph needs of
the step is checked here before the card sees it: a step given its
position as a tensor equals the step given a host int and the
reference's jitted ``decode_step`` (reduced chatglm3-6b, fp32, both plans,
1e-4 as tests/test_torch_serve.py), and it reads nothing back to the host
(a ``TorchDispatchMode`` sees every op it dispatches).  The graph's key,
the hooks that keep the step eager and the launch accounting of a capture
are checked without a card.  ``tests/test_torch_cuda.py`` holds the graph
to the eager step on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.core.cosearch import CoSearchConfig
from repro.core.engine import EngineConfig
from repro.core.sparsity import NM, BlockBernoulli
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.exec import dispatch
from repro_torch.kernels import ops, ref
from repro_torch.launch import compiled, serve
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.transformer import Model
from repro_torch.runtime import inject

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
PROMPT, STEPS, MAX_LEN = 6, 3, 12


@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


@pytest.fixture(scope="module", params=["bitmap", "nm"])
def served(request, fp32):
    """Both packages' compressed models from one plan JSON and the
    reference's own weights."""
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    plan = rexec.build_exec_plan(rcfg, SPARSITY[request.param], tokens=64,
                                 search_cfg=FAST, value_bits=32)
    rpruned = rexec.prune_params(rparams, plan, rcfg)
    rcm = rexec.CompressedModel(RModel(rcfg),
                                rexec.compress_params(rpruned, plan, rcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    cm, pruned = serve.compressed_model(
        cfg, params, texec.ExecPlan.from_json(plan.to_json()), device="cpu")
    return dict(cfg=cfg, rcm=rcm, rpruned=rpruned, cm=cm, pruned=pruned)


def _positions(kind: str, i: int):
    """Step ``i``'s position: one for the batch, or per row (row 1 two
    behind row 0, overwriting its own prefilled entries)."""
    return PROMPT + i if kind == "scalar" else [PROMPT + i, PROMPT - 2 + i]


@pytest.mark.parametrize("kind", ["scalar", "per-row"])
def test_tensor_pos_step_equals_int_pos_and_the_reference(served, kind):
    cfg, cm, pruned = served["cfg"], served["cm"], served["pruned"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab,
                                             (2, PROMPT + STEPS))
    rstep = jax.jit(served["rcm"].decode_step, donate_argnums=(1,))
    _, rc = served["rcm"].prefill(
        served["rpruned"], jnp.asarray(toks[:, :PROMPT], jnp.int32), MAX_LEN)
    _, host = cm.prefill(pruned, torch.from_numpy(toks[:, :PROMPT]), MAX_LEN)
    _, dev = cm.prefill(pruned, torch.from_numpy(toks[:, :PROMPT]), MAX_LEN)
    step = compiled.CompiledStep(cm)
    for i in range(STEPS):
        p = _positions(kind, i)
        tok = torch.from_numpy(toks[:, PROMPT + i])
        rl, rc = rstep(served["rpruned"], rc,
                       jnp.asarray(toks[:, PROMPT + i], jnp.int32),
                       jnp.asarray(p, jnp.int32))
        want, host = cm.decode_step(pruned, host, tok, p)
        got, dev = step(pruned, dev, tok, torch.tensor(p))
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(dev["self"]["k"], host["self"]["k"])
    assert compiled.graphs(cm) == {}


class _HostReads(TorchDispatchMode):
    """Records every op that reads a device value on the host, copies a
    host value to the device, or sizes its output from device data: each
    syncs the host with the card or fails a CUDA graph's capture.  Ops
    run while ``plain`` is above 0 are not recorded: the kernel wrappers'
    CPU branch (``kernels/ref.py``), which a CUDA tensor never reaches."""

    SYNCS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.masked_select.default", "aten.repeat_interleave.Tensor",
             "aten.lift_fresh.default"}

    def __init__(self):
        super().__init__()
        self.found = []
        self.plain = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name.startswith("aten.index") and any(
            isinstance(t, torch.Tensor) and t.dtype == torch.bool
            for t in (args[1] if len(args) > 1 and isinstance(
                args[1], (list, tuple)) else ()))
        if not self.plain and (name in self.SYNCS or bool_index):
            self.found.append(name)
        return func(*args, **(kwargs or {}))


# the plain versions the wrappers run for a CPU tensor in their kernel's
# place (kernels/ops.py); on the card the kernel runs instead
PLAIN_VERSIONS = ("bitmap_spmm_ref", "nm_spmm_ref", "flash_attention_ref")


def _unwatched(mode, fn):
    def plain(*args, **kwargs):
        mode.plain += 1
        try:
            return fn(*args, **kwargs)
        finally:
            mode.plain -= 1
    return plain


@pytest.mark.parametrize("kind", ["scalar", "per-row"])
@pytest.mark.parametrize("which", ["dense", "compressed"])
def test_decode_step_reads_nothing_back_to_the_host(served, kind, which,
                                                    monkeypatch):
    cfg, pruned = served["cfg"], served["pruned"]
    model = Model(cfg) if which == "dense" else served["cm"]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, PROMPT + 2)))
    _, cache = model.prefill(pruned, toks[:, :PROMPT], MAX_LEN)
    # the first step fills host-side caches (the score scale)
    model.decode_step(pruned, cache, toks[:, PROMPT],
                      torch.tensor(_positions(kind, 0)))
    pos = torch.tensor(_positions(kind, 1))
    mode = _HostReads()
    for name in PLAIN_VERSIONS:
        monkeypatch.setattr(ref, name, _unwatched(mode, getattr(ref, name)))
    with mode:
        logits, _ = model.decode_step(pruned, cache, toks[:, PROMPT + 1],
                                      pos)
    assert mode.found == []
    assert logits.shape == (2, cfg.vocab)


def test_the_host_read_check_sees_a_host_read_outside_the_plain_versions(
        monkeypatch):
    """The scope above leaves out the plain versions only: the same
    ``repeat_interleave`` is recorded outside them and not inside."""
    counts = torch.tensor([1, 2])
    mode = _HostReads()
    monkeypatch.setattr(ref, "bitmap_spmm_ref", _unwatched(
        mode, lambda c: torch.repeat_interleave(torch.arange(2), c)))
    with mode:
        ref.bitmap_spmm_ref(counts)
        assert mode.found == []
        torch.repeat_interleave(torch.arange(2), counts)
        x = torch.ones(3)
        x[x > 0] = 2.0
    assert mode.found == ["aten.repeat_interleave.Tensor",
                          "aten.lift_fresh.default", "aten.index_put_.default"]


def test_the_key_differs_in_each_part(served):
    cfg, cm, pruned = served["cfg"], served["cm"], served["pruned"]
    cache = cm.init_cache(2, MAX_LEN, device="cpu")
    tok, pos = torch.zeros(2, dtype=torch.long), torch.tensor(3)
    base = compiled.key(cm, pruned, cache, tok, pos)
    assert compiled.key(cm, pruned, cache, tok, torch.tensor(3)) == base
    assert compiled.key(cm, pruned, cache, tok, 3) == base
    other, _ = serve.compressed_model(
        cfg, Model(cfg).init(seed=1, device="cpu"), cm.store.plan,
        device="cpu")
    variants = [
        compiled.key(cm, pruned, cm.init_cache(3, MAX_LEN, device="cpu"),
                     torch.zeros(3, dtype=torch.long), pos),
        compiled.key(cm, pruned, cm.init_cache(2, MAX_LEN + 1,
                                               device="cpu"), tok, pos),
        compiled.key(cm, pruned, cache, tok, torch.tensor([3, 3])),
        compiled.key(cm, dict(pruned), cache, tok, pos),
        compiled.key(other, pruned, cache, tok, pos),
        compiled.key(cm.model, pruned, cache, tok, pos),
    ]
    with ops.pipeline_default(False):
        variants.append(compiled.key(cm, pruned, cache, tok, pos))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "COMPUTE_DTYPE", torch.bfloat16)
        variants.append(compiled.key(cm, pruned, cache, tok, pos))
    for flags in (("gqagroup",), ("maskedkv",), ("gqagroup", "maskedkv")):
        with optflags.optimizations(flags):
            variants.append(compiled.key(cm, pruned, cache, tok, pos))
    assert len({base, *variants}) == len(variants) + 1


def _hooks():
    yield "instrument", dispatch.instrument()
    yield "kernel_guard", dispatch.kernel_guard(lambda role, e: None)
    yield "kernel_fault_hook", ops.kernel_fault_hook(lambda kind: None)
    yield "kernel_dispatch_hook", ops.kernel_dispatch_hook(
        lambda kind, seconds: None)
    yield "poison_activations", inject.poison_activations("ffn.w_up")
    yield "disable", compiled.disable()


@pytest.mark.parametrize("name", [name for name, ctx in _hooks()])
def test_each_hook_makes_the_step_eager(name):
    card = torch.device("cuda", 0)        # a device object: no card needed
    assert compiled.compiles(card)
    assert not compiled.compiles(torch.device("cpu"))
    with dict(_hooks())[name]:
        assert not compiled.compiles(card)
        if name != "disable":
            assert dispatch.serves_eagerly()
    assert compiled.compiles(card) and not dispatch.serves_eagerly()


def test_on_the_cpu_the_compiled_step_is_the_eager_step(served):
    cfg, cm, pruned = served["cfg"], served["cm"], served["pruned"]
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, PROMPT)))
    toks, _, _ = cm.generate(pruned, prompts, 4, device="cpu")
    with compiled.disable():
        eager, _, _ = cm.generate(pruned, prompts, 4, device="cpu")
    assert torch.equal(toks, eager)
    _, cache = cm.prefill(pruned, prompts, MAX_LEN)
    tok = torch.zeros(2, dtype=torch.long)
    got, out = compiled.CompiledStep(cm)(pruned, cache, tok,
                                         torch.tensor(PROMPT))
    assert out is cache
    _, cache = cm.prefill(pruned, prompts, MAX_LEN)
    want, _ = cm.decode_step(pruned, cache, tok, PROMPT)
    assert torch.equal(got, want)
    assert compiled.graphs(cm) == {}
    assert sum(ops.launch_counts().values()) == 0


def test_a_capture_moves_its_counts_to_the_replays():
    ops.reset_launch_counts()
    ops.add_launches({"nm_spmm": 2})
    with ops.captured_launches() as captured:
        ops.add_launches({"nm_spmm": 7, "bitmap_spmm_naive": 1})
    assert ops.launch_counts()["nm_spmm"] == 2
    assert captured == {"bitmap_spmm": 0, "bitmap_spmm_naive": 1,
                        "nm_spmm": 7, "nm_spmm_naive": 0,
                        "flash_attention": 0}
    ops.add_launches(captured)
    assert ops.launch_counts()["nm_spmm"] == 9
    ops.reset_launch_counts()


def _cpu_graph(fill: float) -> compiled.Graph:
    """A graph's bookkeeping without a capture: CPU buffers only."""
    kv = {name: torch.full((1, 2, 4, 1, 2), fill) for name in ("k", "v")}
    return compiled.Graph(graph=None, params=None, store=None,
                          tokens=torch.zeros(2, dtype=torch.long),
                          pos=torch.zeros((), dtype=torch.long),
                          cache={"self": kv}, logits=torch.zeros(2, 3),
                          launches={}, capture_ms=0.0)


def test_a_graph_serves_one_cache_at_a_time():
    """The cache a graph handed out last goes on without a copy; another
    cache is copied in and gets a new handle; a handle from before that
    copy raises; another graph's handle is another cache."""
    g, other = _cpu_graph(0.0), _cpu_graph(5.0)
    first = g.handle()
    assert g.adopt(first) is first
    assert first["self"]["k"] is g.cache["self"]["k"]
    prefill = {"self": {name: torch.full((1, 2, 4, 1, 2), 1.0)
                        for name in ("k", "v")}}
    second = g.adopt(prefill)
    assert second is not first and g.serial == 1
    assert torch.equal(second["self"]["v"], prefill["self"]["v"])
    assert second["self"]["v"] is g.cache["self"]["v"]
    with pytest.raises(RuntimeError, match="another cache"):
        g.adopt(first)
    assert g.adopt(second) is second
    third = g.adopt(other.handle())
    assert g.serial == 2 and float(third["self"]["k"].max()) == 5.0
    with pytest.raises(RuntimeError, match="another cache"):
        g.adopt(second)
