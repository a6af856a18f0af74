"""Long Range Arena data (the port's own copy of `sea_tpu/data/lra.py`,
numpy only).

ListOps is synthetic by construction: `listops_dataset` generates nested
MIN / MAX / MED / SM (sum mod 10) expressions of bounded depth, tokenised by
word, with exact labels (cached by its parameters as an `.npz` under
`cache_dir`, `saves/lra_data` at the repository root by default; None
caches nothing). `text_dataset` (IMDb reviews as bytes, CLS at position 0)
and `image_dataset` (CIFAR-10 as 8-bit grey pixel sequences) read a local
`aclImdb/` or `cifar-10-batches-py/` under `data_dir` (or `$SEA_LRA_DATA`);
without one they give synthetic streams of the same shapes and
vocabularies. Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

from .glue import ArrayDataset

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "saves", "lra_data")

LISTOPS_TOKENS = (
    ["<pad>", "<cls>", "[MIN", "[MAX", "[MED", "[SM", "]"]
    + [str(i) for i in range(10)]
)
LISTOPS_VOCAB = {tok: i for i, tok in enumerate(LISTOPS_TOKENS)}


def _gen_listops_expr(rng, max_depth: int, max_args: int) -> Tuple[List[str], int]:
    op = rng.choice(["[MIN", "[MAX", "[MED", "[SM"])
    n_args = int(rng.integers(2, max_args + 1))
    toks: List[str] = [op]
    vals: List[int] = []
    for _ in range(n_args):
        if max_depth > 1 and rng.uniform() < 0.35:
            sub, val = _gen_listops_expr(rng, max_depth - 1, max_args)
            toks.extend(sub)
            vals.append(val)
        else:
            d = int(rng.integers(0, 10))
            toks.append(str(d))
            vals.append(d)
    toks.append("]")
    if op == "[MIN":
        out = min(vals)
    elif op == "[MAX":
        out = max(vals)
    elif op == "[MED":
        out = int(np.median(vals))
    else:
        out = sum(vals) % 10
    return toks, out


def listops_dataset(n: int = 2048, max_length: int = 512, max_depth: int = 6,
                    max_args: int = 8, seed: int = 0,
                    cache_dir: Optional[str] = DEFAULT_CACHE_DIR) -> ArrayDataset:
    """`n` expressions of at most `max_length` - 1 tokens after a CLS,
    right-padded with <pad>."""
    cache = None
    if cache_dir:
        cache = os.path.join(
            cache_dir, f"listops_n{n}_L{max_length}_d{max_depth}_a{max_args}_s{seed}.npz")
        if os.path.exists(cache):
            z = np.load(cache)
            return ArrayDataset(z["ids"], z["mask"], z["tt"], z["labels"])
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, max_length), np.int32)
    mask = np.zeros((n, max_length), np.int32)
    labels = np.zeros((n,), np.int32)
    i = 0
    while i < n:
        toks, val = _gen_listops_expr(rng, max_depth, max_args)
        if len(toks) + 1 > max_length:
            continue
        seq = [LISTOPS_VOCAB["<cls>"]] + [LISTOPS_VOCAB[tok] for tok in toks]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = 1
        labels[i] = val
        i += 1
    tt = np.zeros_like(ids)
    if cache:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez_compressed(cache, ids=ids, mask=mask, tt=tt, labels=labels)
    return ArrayDataset(ids, mask, tt, labels)


def _local_dir(data_dir, name):
    if data_dir is None:
        data_dir = os.environ.get("SEA_LRA_DATA", "")
    cand = os.path.join(data_dir, name) if data_dir else ""
    return cand if cand and os.path.isdir(cand) else None


def imdb_bytes_dataset(root: str, split: str, max_length: int, n: int = 0,
                       seed: int = 0) -> ArrayDataset:
    """IMDb review bytes (vocabulary 256, CLS 1 at position 0), truncated
    or right-padded to `max_length`."""
    rng = np.random.default_rng(seed)
    files = []
    for label, sub in ((1, "pos"), (0, "neg")):
        d = os.path.join(root, "train" if split == "train" else "test", sub)
        for f in sorted(os.listdir(d)):
            if f.endswith(".txt"):
                files.append((os.path.join(d, f), label))
    rng.shuffle(files)
    if n:
        files = files[:n]
    N = len(files)
    ids = np.zeros((N, max_length), np.int32)
    mask = np.zeros((N, max_length), np.int32)
    labels = np.zeros((N,), np.int32)
    for i, (path, label) in enumerate(files):
        with open(path, "rb") as f:
            raw = f.read()[: max_length - 1]
        seq = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
        ids[i, 0] = 1
        ids[i, 1: 1 + len(seq)] = seq
        mask[i, : 1 + len(seq)] = 1
        labels[i] = label
    return ArrayDataset(ids, mask, np.zeros_like(ids), labels)


def text_dataset(n: int = 1024, max_length: int = 1024, seed: int = 0,
                 data_dir=None) -> ArrayDataset:
    """Byte-level classification: the local IMDb copy, or a stream whose
    class plants marker bytes."""
    root = _local_dir(data_dir, "aclImdb")
    if root is not None:
        return imdb_bytes_dataset(root, "train" if seed == 0 else "test", max_length, n=n,
                                  seed=seed)
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 256, (n, max_length)).astype(np.int32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    for i in range(n):
        pos = rng.integers(1, max_length, size=max_length // 16)
        ids[i, pos] = 30 + labels[i]
        ids[i, 0] = 1
    mask = np.ones((n, max_length), np.int32)
    return ArrayDataset(ids, mask, np.zeros_like(ids), labels)


def cifar_gray_dataset(root: str, split: str, n: int = 0) -> ArrayDataset:
    """CIFAR-10's python batches as 8-bit grey length-1024 pixel sequences."""
    batches = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
               else ["test_batch"])
    xs, ys = [], []
    for b in batches:
        path = os.path.join(root, b)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.float32))
        ys.append(np.asarray(d[b"labels"], np.int32))
    x, y = np.concatenate(xs), np.concatenate(ys)
    if n:
        x, y = x[:n], y[:n]
    gray = np.clip(np.round(x.reshape(-1, 3, 1024).mean(1)), 0, 255).astype(np.int32)
    return ArrayDataset(gray, np.ones_like(gray, np.int32), np.zeros_like(gray), y)


def image_dataset(n: int = 1024, side: int = 32, seed: int = 0, data_dir=None) -> ArrayDataset:
    """Pixel-sequence classification: the local CIFAR-10 batches, or
    class-dependent stripes over noise."""
    root = _local_dir(data_dir, "cifar-10-batches-py")
    if root is not None:
        return cifar_gray_dataset(root, "train" if seed == 0 else "test", n=n)
    rng = np.random.default_rng(seed)
    T = side * side
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = rng.integers(0, 64, (n, side, side)).astype(np.int32)
    xs = np.arange(side)
    for i in range(n):
        c = labels[i]
        stripe = ((xs[None, :] * (c % 5 + 1) + (xs[:, None] * (c // 5 + 1))) % 8) < 4
        imgs[i] = np.where(stripe, imgs[i] + 128, imgs[i])
    ids = imgs.reshape(n, T)
    return ArrayDataset(ids, np.ones((n, T), np.int32), np.zeros_like(ids), labels)


@dataclasses.dataclass(frozen=True)
class LraTaskSpec:
    """A task's model and optimiser settings (the reference's)."""

    batch_size: int
    lr: float
    wd: float
    num_heads: int
    num_layers: int
    hidden_size: int
    ffn_dim: int
    num_labels: int
    max_position_embeddings: int
    vocab_size: int
    max_length: int


LRA_TASKS = {
    "listops": LraTaskSpec(32, 2e-3, 1e-1, 8, 6, 512, 2048, 10, 2048,
                           len(LISTOPS_TOKENS), 512),
    "text": LraTaskSpec(16, 1e-5, 1e-1, 4, 4, 256, 1024, 2, 1024, 256, 1024),
    "image": LraTaskSpec(256, 1e-3, 0.0, 1, 1, 32, 64, 10, 1024, 256, 1024),
}


def get_lra(task: str, split: str = "train", n: int = 1024, max_length=None,
            max_depth: int = 6, data_dir=None, cache_dir: Optional[str] = DEFAULT_CACHE_DIR):
    """A task's split ('train' seed 0, any other seed 1)."""
    spec = LRA_TASKS[task]
    L = max_length or spec.max_length
    seed = 0 if split == "train" else 1
    if task == "listops":
        return listops_dataset(n, L, max_depth=max_depth, seed=seed, cache_dir=cache_dir)
    if task == "text":
        return text_dataset(n, L, seed=seed, data_dir=data_dir)
    if task == "image":
        return image_dataset(n, side=int(np.sqrt(L)), seed=seed, data_dir=data_dir)
    raise ValueError(task)
