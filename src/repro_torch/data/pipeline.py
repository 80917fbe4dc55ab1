"""Deterministic synthetic data pipeline with document packing.

Port of `repro.data.pipeline`: a copy of it, numpy only, so that the port
and the reference draw the same batches bit for bit. The functions return
numpy arrays; the caller moves them to its device.

Keyed by (seed, step, shard): a restarted or elastically re-scaled job
replays exactly the same global batch order — the straggler/elasticity
story of DESIGN.md §6. Tokens follow a Zipfian unigram draw with Markov
locality so LM losses move during smoke training (pure uniform tokens give
flat loss). A binary-file reader covers the "real corpus" path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    doc_len_mean: int = 512
    eos_id: int = 0


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard, 0xC0FFEE])
    )


def synthetic_batch(cfg: DataConfig, step: int, shard: int = 0, n_shards: int = 1) -> dict:
    """One shard's (tokens, labels) for `step` — pure function of the key."""
    b = cfg.global_batch // n_shards
    rng = _rng_for(cfg, step, shard)
    # zipf unigram with markov locality + packed documents
    base = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len)).astype(np.int64)
    tok = base % (cfg.vocab - 1) + 1
    drift = rng.integers(0, 16, size=(b, cfg.seq_len))
    tok = np.where(drift < 8, np.roll(tok, 1, axis=1), tok)  # local correlation
    # insert document boundaries (packing)
    n_docs = max(cfg.seq_len // max(cfg.doc_len_mean, 16), 1)
    for i in range(b):
        cuts = rng.integers(1, cfg.seq_len, size=n_docs)
        tok[i, cuts] = cfg.eos_id
    labels = np.concatenate([tok[:, 1:], np.full((b, 1), cfg.eos_id, tok.dtype)], axis=1)
    return {"tokens": tok.astype(np.int32), "labels": labels.astype(np.int32)}


def make_batch_iterator(
    cfg: DataConfig, start_step: int = 0, shard: int = 0, n_shards: int = 1
) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, shard, n_shards)
        step += 1


def read_binary_corpus(path: str, cfg: DataConfig, step: int) -> dict:
    """Real-corpus path: flat int32 token file, strided deterministic reads."""
    data = np.memmap(path, dtype=np.int32, mode="r")
    n = cfg.global_batch * cfg.seq_len
    total = len(data) - 1
    off = (step * n) % max(total - n, 1)
    tok = np.array(data[off : off + n]).reshape(cfg.global_batch, cfg.seq_len)
    lab = np.array(data[off + 1 : off + 1 + n]).reshape(cfg.global_batch, cfg.seq_len)
    return {"tokens": tok, "labels": lab}
