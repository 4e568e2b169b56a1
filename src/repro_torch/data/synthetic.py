"""Deterministic synthetic token corpus with restorable, host-sharded
iteration.

The port of ``repro.data.synthetic``, copied: numpy only, so the port
draws the very batches the reference draws. The stream is a pure
function of (seed, step, host_index) — no iterator state needs
checkpointing: after restart, ``batch_at(step)`` regenerates exactly the
batch that step would have seen. That property is what makes kill/resume
exact (``launch/train.py``; ``tests/test_torch_train.py`` holds both
packages' batches equal bit for bit).

The token distribution is a mixture of Zipfian unigrams and short
repeated motifs, so cross-entropy decreases measurably within a few
hundred steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 1234
    n_hosts: int = 1
    host_index: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticCorpus:
    """Stateless batch generator; ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-ish unigram distribution over the vocab.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab_size, size=(64, cfg.motif_len))

    def batch_at(self, step: int) -> dict:
        """-> {tokens: (host_batch, S) int32, labels: (host_batch, S)}."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index, 0xDA7A))
        b, s = cfg.host_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._p)
        # Overwrite random spans with repeated motifs (learnable structure).
        n_spans = int(cfg.motif_prob * b * (s // cfg.motif_len))
        if n_spans:
            rows = rng.integers(0, b, n_spans)
            cols = rng.integers(0, s + 1 - cfg.motif_len, n_spans)
            which = rng.integers(0, len(self._motifs), n_spans)
            for r, c, w in zip(rows, cols, which):
                toks[r, c:c + cfg.motif_len] = self._motifs[w]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def embeds_at(self, step: int, d_model: int) -> dict:
        """Stub-frontend variant: precomputed embeddings instead of tokens
        (audio/VLM archs)."""
        batch = self.batch_at(step)
        rng = np.random.default_rng((self.cfg.seed, step, 7))
        table = rng.standard_normal((self.cfg.vocab_size, d_model)).astype(
            np.float32) * 0.02
        return {"input_embeds": table[batch["tokens"]],
                "labels": batch["labels"]}
