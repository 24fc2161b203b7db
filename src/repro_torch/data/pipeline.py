"""Deterministic, shard-aware synthetic token pipeline (a copy of
``repro.data.pipeline``'s numpy, so the batches are the reference's bit
for bit).

Every batch is a pure function of (seed, step, shard): there is no
iterator state, so restart-after-failure resumes exactly (the checkpoint
only needs the step counter) and data parallelism never double-reads.
Token statistics are Zipf-distributed with short-range repetition.

As in the reference, ``make_batch``'s labels are the input tokens
themselves, not shifted by one: ``loss_fn`` asks each position for its
own token.  Batches are numpy; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.config import ModelConfig
from ..models.frontends import frontend_split


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_s: float = 1.1
    repeat_prob: float = 0.3      # P(copy a recent token): learnable signal


class SyntheticTokens:
    """Stateless batch source: ``batch(step, shard, n_shards)``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf probabilities over the vocab (heavy-tailed like text).
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_s)
        self._probs = p / p.sum()

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> np.ndarray:
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        local = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        toks = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len),
                          p=self._probs)
        # short-range repetition: token t copies token t-delta sometimes
        rep = rng.random((local, cfg.seq_len)) < cfg.repeat_prob
        delta = rng.integers(1, 8, size=(local, cfg.seq_len))
        idx = np.maximum(np.arange(cfg.seq_len)[None, :] - delta, 0)
        toks = np.where(rep, np.take_along_axis(toks, idx, axis=1), toks)
        return toks.astype(np.int32)


def make_batch(model_cfg: ModelConfig, data: SyntheticTokens, step: int,
               shard: int = 0, n_shards: int = 1) -> dict:
    """Model-ready batch dict ({tokens|embeds}, labels) for any frontend."""
    toks = data.batch(step, shard, n_shards)
    b, s = toks.shape
    n_emb, n_text = frontend_split(model_cfg, s)
    out: dict = {"labels": toks.copy()}
    if n_emb:
        rng = np.random.default_rng(np.random.SeedSequence(
            [data.cfg.seed, step, shard, 7]))
        out["embeds"] = rng.normal(
            0, 1, (b, n_emb, model_cfg.d_model)).astype(np.float32)
        if model_cfg.frontend == "vision":
            out["labels"][:, :n_emb] = -1
    if n_text:
        out["tokens"] = toks[:, n_emb:] if n_emb else toks
    return out
