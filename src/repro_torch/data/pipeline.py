"""Deterministic synthetic token pipeline: a numpy-only copy of
``repro.data.pipeline``.

For the same seed and step it yields byte-identical batches to the JAX
package's (the state is ``(seed, step)``; every batch comes from its own
``np.random.SeedSequence([seed, step, host])``). The token stream mixes
Zipf-distributed unigrams with short repeated motifs, so a model can learn
from it with no data on disk. Batches are numpy arrays; ``repro_torch.
convert.batch_to_tensors`` moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch_size: int = 8          # global batch
    seq_len: int = 128
    host_index: int = 0
    host_count: int = 1
    motif_len: int = 8
    motif_prob: float = 0.5


class SyntheticPipeline:
    """Stateless-resumable iterator over synthetic LM batches."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, step: int = 0):
        if data.batch_size % data.host_count:
            raise ValueError(
                f"global batch {data.batch_size} not divisible by {data.host_count} hosts")
        self.cfg = cfg
        self.data = data
        self.step = step
        self._local = data.batch_size // data.host_count
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks**1.1
        self._probs = probs / probs.sum()

    def state_dict(self) -> Dict:
        return {"seed": self.data.seed, "step": self.step}

    def load_state_dict(self, state: Dict) -> None:
        if state["seed"] != self.data.seed:
            raise ValueError("data seed changed mid-run")
        self.step = int(state["step"])

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.data.seed, step, self.data.host_index]))

    def _tokens(self, rng: np.random.Generator, n_rows: int) -> np.ndarray:
        d = self.data
        S = d.seq_len + 1  # +1: shift into (inputs, labels)
        toks = rng.choice(self.cfg.vocab_size, size=(n_rows, S), p=self._probs).astype(np.int32)
        # plant motifs: spans repeated immediately, giving learnable structure
        for r in range(n_rows):
            if rng.random() < d.motif_prob and S >= 2 * d.motif_len + 1:
                start = rng.integers(0, S - 2 * d.motif_len)
                motif = toks[r, start:start + d.motif_len]
                toks[r, start + d.motif_len:start + 2 * d.motif_len] = motif
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg, d = self.cfg, self.data
        rng = self._rng_for(self.step)
        self.step += 1
        B, S = self._local, d.seq_len

        if cfg.frontend == "audio_frames":
            labels = self._tokens(rng, B)[:, 1:]
            embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32) * 0.1
            return {"embeds": embeds, "labels": labels}

        if cfg.frontend == "vision_patches":
            P = cfg.num_prefix
            if S <= P:
                raise ValueError(f"seq_len {S} must exceed the {P} prefix patches")
            toks = self._tokens(rng, B)
            embeds = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32) * 0.1
            labels = toks[:, 1:S + 1]
            mask = np.zeros((B, S), np.float32)
            mask[:, P:] = 1.0
            return {"embeds": embeds, "tokens": toks[:, :S - P], "labels": labels,
                    "loss_mask": mask}

        toks = self._tokens(rng, B)
        return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
