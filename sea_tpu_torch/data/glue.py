"""GLUE data for BERT KD (the port's own copy of `sea_tpu/data/glue.py`,
numpy only): tokenised arrays padded to `max_length`, per-task label counts
and batch sizes, and a synthetic fallback.

`get_glue` reads a local tokenised cache, `{cache_dir}/glue_{subset}_{split}.npz`
(arrays `input_ids`, `attention_mask`, `token_type_ids`, `labels`, as the
bert-base-uncased tokenizer gives them; `saves/data/glue` at the repository
root by default). Without it, it builds `synthetic_glue`: classification
data whose label plants marker tokens, so that distillation and accuracy can
move, at `min(max_length, 64)` tokens as the JAX package's fallback.
Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "saves", "data", "glue")

TASK_TO_KEYS = {
    "cola": ("sentence", None),
    "mnli": ("premise", "hypothesis"),
    "mrpc": ("sentence1", "sentence2"),
    "qnli": ("question", "sentence"),
    "qqp": ("question1", "question2"),
    "rte": ("sentence1", "sentence2"),
    "sst2": ("sentence", None),
    "stsb": ("sentence1", "sentence2"),
    "wnli": ("sentence1", "sentence2"),
}

TASK_NUM_LABELS = {
    "cola": 2, "mnli": 3, "mrpc": 2, "qnli": 2, "qqp": 2,
    "rte": 2, "sst2": 2, "stsb": 1, "wnli": 2,
}

# the reference trainer's per-task batch sizes
TASK_BATCH_SIZE = {
    "cola": 64, "mnli": 4, "mrpc": 32, "qnli": 4, "qqp": 16,
    "rte": 8, "sst2": 16, "stsb": 16, "wnli": 32,
}


@dataclasses.dataclass
class ArrayDataset:
    input_ids: np.ndarray  # (n, T)
    attention_mask: np.ndarray
    token_type_ids: np.ndarray
    labels: np.ndarray  # (n,)

    def __len__(self):
        return len(self.input_ids)

    def batches(self, batch_size: int, shuffle=False, seed=0, shard_id=0,
                num_shards=1) -> Iterator[Tuple[np.ndarray, ...]]:
        """(input_ids, attention_mask, token_type_ids, labels) batches; the
        last partial batch is dropped."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        order = order[shard_id::num_shards]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            yield (self.input_ids[idx], self.attention_mask[idx],
                   self.token_type_ids[idx], self.labels[idx])


def synthetic_glue(subset: str, split: str, n: int = 512, max_length: int = 64,
                   vocab_size: int = 30522, seed: int = 0) -> ArrayDataset:
    """Right-padded examples of T/4 to T tokens whose (noisy) label plants
    marker tokens (regression labels for stsb)."""
    num_labels = TASK_NUM_LABELS[subset]
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    T = max_length
    ids = rng.integers(1000, vocab_size, (n, T)).astype(np.int32)
    lens = rng.integers(T // 4, T + 1, n)
    mask = np.zeros((n, T), np.int32)
    labels = rng.integers(0, max(num_labels, 2), n).astype(np.int32)
    for i in range(n):
        mask[i, : lens[i]] = 1
        ids[i, lens[i]:] = 0
        ids[i, 0] = 101  # [CLS]
        pos = rng.integers(1, lens[i], size=max(lens[i] // 8, 1))
        ids[i, pos] = 500 + labels[i]
    if num_labels == 1:
        labels = labels.astype(np.float32) + rng.uniform(0, 0.5, n).astype(np.float32)
    return ArrayDataset(ids, mask, np.zeros((n, T), np.int32), labels)


def load_glue_cache(subset: str, split: str, cache_dir: Optional[str] = None) -> ArrayDataset:
    """The tokenised cache of `subset`'s `split`; FileNotFoundError without it."""
    path = os.path.join(cache_dir or DEFAULT_CACHE_DIR, f"glue_{subset}_{split}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no tokenised GLUE cache at {path}")
    z = np.load(path)
    return ArrayDataset(z["input_ids"].astype(np.int32), z["attention_mask"].astype(np.int32),
                        z["token_type_ids"].astype(np.int32), z["labels"])


def get_glue(subset: str, split: str = "train", max_length: int = 256,
             synthetic_fallback: bool = True, n_synth: int = 512,
             cache_dir: Optional[str] = None) -> ArrayDataset:
    """The cached split, or `synthetic_glue` at min(max_length, 64) tokens
    when the cache is absent and `synthetic_fallback`."""
    try:
        return load_glue_cache(subset, split, cache_dir)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        return synthetic_glue(subset, split, n=n_synth, max_length=min(max_length, 64))
