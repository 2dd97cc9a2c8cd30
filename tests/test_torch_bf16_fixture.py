"""The bf16 serving fixture (``tests/_bf16_serving.py``): the reference's
greedy run of reduced chatglm3-6b on the shipped bitmap plan, kept as a
committed file so the port can be held to it on a machine without JAX
(``tests/test_torch_cuda.py::test_bf16_serving_holds_to_the_reference_fixture``).

The committed file must equal a fresh run of the reference, so it cannot
drift; the port's CPU run is held to it here with the same check the card
test makes: equal tokens, and each step's top logits within
``tests/test_torch_bf16.py``'s compressed-prefill bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _bf16_serving as fx
from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro_torch.exec.plans import PLANS_DIR


def _reference_record() -> dict:
    assert RL.COMPUTE_DTYPE == jnp.bfloat16
    cfg = rget_config("chatglm3-6b").reduced()
    params = jax.tree.map(jnp.asarray, fx.reference_params(cfg))
    plan = rexec.ExecPlan.from_json(
        (PLANS_DIR / "chatglm3-6b.reduced.bitmap.json").read_text())
    pruned = rexec.prune_params(params, plan, cfg)
    cm = rexec.CompressedModel(RModel(cfg),
                               rexec.compress_params(pruned, plan, cfg))
    toks = jnp.asarray(fx.prompts(cfg), jnp.int32)
    max_len = fx.PROMPT + fx.GEN
    # the reference's own jit-vs-eager spread on the dense prefill logits
    dense_jit = np.asarray(RModel(cfg).prefill(pruned, toks, max_len)[0])
    with jax.disable_jit():
        dense_eager = np.asarray(RModel(cfg).prefill(pruned, toks,
                                                     max_len)[0])
    # the reference's serving loop (launch/serve.py): jitted prefill and
    # decode step, greedy
    prefill = jax.jit(functools.partial(cm.prefill, max_len=max_len))
    step = jax.jit(cm.decode_step)
    logits, cache = prefill(pruned, toks)
    logits = logits[:, -1]
    steps, out = [], []
    for t in range(fx.PROMPT, fx.PROMPT + fx.GEN):
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
        if t < fx.PROMPT + fx.GEN - 1:
            logits, cache = step(pruned, cache, tok, jnp.asarray(t, jnp.int32))
    tokens = np.stack(out, axis=1)
    served = np.asarray(cm.generate(pruned, toks, fx.GEN)[0])
    assert np.array_equal(tokens, served), "the loop is not the reference's"
    return fx.record(tokens, steps, np.abs(dense_jit - dense_eager).max())


@pytest.fixture(scope="module")
def reference():
    return _reference_record()


def test_committed_fixture_equals_a_fresh_reference_run(reference):
    assert fx.FIXTURE.read_text() == fx.dump(reference)


def test_fixture_covers_every_step_and_row(reference):
    rec = fx.load()
    assert len(rec["steps"]) == fx.GEN
    assert np.asarray(rec["tokens"]).shape == (fx.BATCH, fx.GEN)
    for s, st in enumerate(rec["steps"]):
        ids = np.asarray(st["ids"])
        assert ids.shape == (fx.BATCH, fx.TOP)
        # each step's greedy token is its top logit's id
        assert ids[:, 0].tolist() == [row[s] for row in rec["tokens"]]
    assert 0.0 <= rec["spread"] < 0.1


def test_port_on_cpu_holds_to_the_fixture():
    tokens, steps = fx.port_run("cpu")
    assert fx.misses(fx.load(), tokens, steps) == []


def test_a_wrong_logit_misses_the_fixture():
    """The check is not vacuous: one top logit moved by two ulps of its
    step's bound fails it, and so does a changed token."""
    rec = fx.load()
    tokens, steps = fx.port_run("cpu")
    s, b = 1, 0
    i = rec["steps"][s]["ids"][b][3]
    bad = [lg.copy() for lg in steps]
    bad[s][b, i] += 2 * (rec["spread"] + fx.bf16_ulp(
        float(np.abs(np.asarray(rec["steps"][s]["logits"])).max())))
    assert len(fx.misses(rec, tokens, bad)) == 1
    wrong = tokens.copy()
    wrong[1, 2] += 1
    assert fx.misses(rec, wrong, steps)[0].startswith("tokens")
