"""Wikitext-2 corpus for causal-LM KD: strided windows over a flat token
array (the port's own copy of `sea_tpu/data/wikitext2.py`, numpy only).

The corpus is tokenised once into a flat array; windows of `max_length`
tokens start every `stride` tokens, and only each window's last `stride`
targets are supervised (labels -100 before them), so that the windowed
perplexity is the standard strided one. Tokens come from a local cache,
`{cache_dir}/wikitext2_{split}.npy` (`saves/data` at the repository root by
default), or for `dataset="openwebtext"` (the reference's OpenWebText swap)
`{cache_dir}/openwebtext_{split}.npy`; without it, `synthetic_corpus` gives
a deterministic Zipf-like stream with the same interface. Nothing is
downloaded.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "saves", "data")


@dataclasses.dataclass
class WindowedCorpus:
    """Flat token array served as strided (input, target-mask) windows."""

    tokens: np.ndarray  # (total,) int32
    max_length: int
    stride: int

    def __post_init__(self):
        if self.stride > self.max_length:
            raise ValueError(f"stride {self.stride} > max_length {self.max_length}")

    def __len__(self) -> int:
        total = len(self.tokens)
        if total <= self.max_length:
            return 1
        return 1 + (total - self.max_length + self.stride - 1) // self.stride

    def window(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids (L,), labels (L,)), labels -100 outside the supervised
        tail."""
        total = len(self.tokens)
        begin = min(idx * self.stride, max(total - self.max_length, 0))
        end = min(begin + self.max_length, total)
        prev_end = begin if idx == 0 else min((idx - 1) * self.stride + self.max_length, total)
        trg_len = end - prev_end if idx > 0 else end - begin
        ids = self.tokens[begin:end].astype(np.int32)
        labels = ids.astype(np.int64).copy()
        labels[: len(ids) - trg_len] = -100
        return ids, labels

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0,
        shard_id: int = 0, num_shards: int = 1,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(input_ids, attention_mask, labels) batches padded to max_length
        (pad id 1, mask 0, label -100); the last partial batch is dropped.
        Shard `shard_id` of `num_shards` takes every num_shards-th window of
        the (shuffled) order from its own, round-robin (JAX's
        DistributedSampler analogue)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        order = order[shard_id::num_shards]
        L = self.max_length
        for i in range(0, len(order), batch_size):
            chunk = order[i : i + batch_size]
            if len(chunk) < batch_size:
                break
            ids_b = np.full((batch_size, L), 1, np.int32)
            mask_b = np.zeros((batch_size, L), np.int32)
            lab_b = np.full((batch_size, L), -100, np.int64)
            for j, idx in enumerate(chunk):
                ids, labels = self.window(int(idx))
                ids_b[j, : len(ids)] = ids
                mask_b[j, : len(ids)] = 1
                lab_b[j, : len(labels)] = labels
            yield ids_b, mask_b, lab_b


def synthetic_corpus(
    vocab_size: int = 50272, total_tokens: int = 200_000, seed: int = 0
) -> np.ndarray:
    """Deterministic Zipf-like token stream with local repetition (each
    token repeats the previous one with p = 0.15), so that a language model
    has something to learn."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size - 4)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    base = rng.choice(vocab_size - 5, size=total_tokens, p=probs) + 4
    rep = rng.uniform(size=total_tokens) < 0.15
    out = base.copy()
    out[1:][rep[1:]] = out[:-1][rep[1:]]
    return out.astype(np.int32)


def load_wikitext2_tokens(split: str = "train", cache_dir: Optional[str] = None) -> np.ndarray:
    """The cached token array of wikitext-2-raw-v1's `split` (tokenised
    with facebook/opt-125m's tokenizer); FileNotFoundError without it."""
    cache = os.path.join(cache_dir or DEFAULT_CACHE_DIR, f"wikitext2_{split}.npy")
    if not os.path.exists(cache):
        raise FileNotFoundError(f"no cached tokens at {cache}")
    return np.load(cache)


def load_openwebtext_tokens(split: str = "train", cache_dir: Optional[str] = None) -> np.ndarray:
    """The cached token array of OpenWebText's `split` (its first documents,
    tokenised with facebook/opt-125m's tokenizer); FileNotFoundError
    without it."""
    cache = os.path.join(cache_dir or DEFAULT_CACHE_DIR, f"openwebtext_{split}.npy")
    if not os.path.exists(cache):
        raise FileNotFoundError(f"no cached tokens at {cache}")
    return np.load(cache)


CORPORA = {"wikitext2": load_wikitext2_tokens, "openwebtext": load_openwebtext_tokens}


def get_corpus(
    max_length: int,
    stride: int,
    split: str = "train",
    synthetic_fallback: bool = True,
    vocab_size: int = 50272,
    cache_dir: Optional[str] = None,
    dataset: str = "wikitext2",
) -> WindowedCorpus:
    """The cached split of `dataset` ('wikitext2' or 'openwebtext'), or the
    synthetic stream (seed 0 for 'train', 1 otherwise) when the cache is
    absent and `synthetic_fallback`."""
    if dataset not in CORPORA:
        raise ValueError(f"dataset {dataset!r}: one of {sorted(CORPORA)}")
    try:
        tokens = CORPORA[dataset](split, cache_dir)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        tokens = synthetic_corpus(vocab_size=vocab_size, seed=0 if split == "train" else 1)
    return WindowedCorpus(tokens=tokens, max_length=max_length, stride=stride)
