"""Deterministic, shardable synthetic-token data pipeline: the port of the
reference's ``repro.data.pipeline``.

Batch ``i`` is a pure function of (seed, i, host): numpy draws from
``SeedSequence([seed, step, host_id])`` in the reference's order, so the
port's batches equal the reference's exactly.  They come back as int32
``tokens`` / ``labels`` (and fp32 ``enc_frames`` for an encoder-decoder)
on the pipeline's device.  State is a single integer, trivially
checkpointable.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step}

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(step=int(d["step"]))


@dataclasses.dataclass
class TokenPipeline:
    """Markov-ish synthetic LM stream: structured enough that loss
    decreases under training (next token correlates with current),
    deterministic per (seed, step, shard)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    enc_seq: int = 0             # >0: also emit encoder frame embeddings
    d_model: int = 0
    device: str = "cuda"

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        """The (deterministic) host-local batch for a global step."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.host_batch, self.seq_len, self.vocab
        # token_t+1 = (a·token_t + drift + noise) mod v → learnable structure
        a = 31
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = (rng.random((b, s)) < 0.15)
        jumps = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = (toks[:, t] * a + 7) % v
            toks[:, t + 1] = np.where(noise[:, t], jumps[:, t], nxt)
        dev = resolve(self.device)
        out = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
        if self.enc_seq:
            out["enc_frames"] = torch.from_numpy(
                rng.normal(size=(b, self.enc_seq, self.d_model)).astype(
                    np.float32)).to(dev)
        return out

    def iterate(self, state: Optional[PipelineState] = None
                ) -> Iterator[tuple[PipelineState, dict]]:
        state = state or PipelineState()
        while True:
            batch = self.batch_at(state.step)
            state = PipelineState(state.step + 1)
            yield state, batch

    def reshard(self, n_hosts: int, host_id: int) -> "TokenPipeline":
        """Elastic re-shard: same stream, new host split (fault
        recovery)."""
        return dataclasses.replace(self, n_hosts=n_hosts, host_id=host_id)
