"""MMLU (hendrycks-test) loader and 4-way choice scoring (the port's own copy
of `sea_tpu/data/mmlu.py`, which imports JAX).

`load_mmlu` reads the standard hendrycks CSV layout from a local directory
(`{subject}_{split}.csv` rows of question, A, B, C, D, answer letter, no
header); without a directory, or with no files in it, it builds the JAX
package's deterministic synthetic task (the same examples for a seed).
Scoring follows the original MMLU harness: the model's final-position logits
over the four answer-letter tokens, argmax. `make_choice_score_fn` scores a
batch through a causal LM's forward (`benchmarking=True`: the SEA benchmark
path, kernel K1 on the card); `synthetic_tokenizer` is the offline hash
tokenizer.

    python -m sea_tpu_torch.data.mmlu --model llama-tiny --fewshot 0 --device cpu
    python -m sea_tpu_torch.data.mmlu --model llama-7b --checkpoint DIR \\
        --data DIR --tokenizer DIR --fewshot 5 --benchmarking

`--checkpoint` and `--tokenizer` read local directories only; nothing is
downloaded.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import json
import os
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CHOICES = ("A", "B", "C", "D")


@dataclasses.dataclass
class MMLUExample:
    subject: str
    question: str
    choices: Tuple[str, str, str, str]
    answer: int  # 0..3


def _read_csv(path: str, subject: str) -> List[MMLUExample]:
    out = []
    with open(path, newline="", encoding="utf-8") as fh:
        for row in csv.reader(fh):
            if len(row) < 6:
                continue
            q, a, b, c, d, ans = row[:6]
            ans = ans.strip().upper()
            if ans not in CHOICES:
                continue
            out.append(MMLUExample(subject, q, (a, b, c, d), CHOICES.index(ans)))
    return out


def load_mmlu(
    data_dir: Optional[str] = None,
    split: str = "test",
    subjects: Optional[Sequence[str]] = None,
    synthetic_examples: int = 64,
    seed: int = 0,
) -> List[MMLUExample]:
    """The `{subject}_{split}.csv` files of `data_dir` (hendrycks layout,
    optionally under a `{split}/` subdirectory); the synthetic task when
    there is no directory or no file in it."""
    if data_dir:
        paths = sorted(
            glob.glob(os.path.join(data_dir, f"*_{split}.csv"))
            + glob.glob(os.path.join(data_dir, split, f"*_{split}.csv"))
        )
        examples = []
        for p in paths:
            subject = os.path.basename(p)[: -len(f"_{split}.csv")]
            if subjects and subject not in subjects:
                continue
            examples.extend(_read_csv(p, subject))
        if examples:
            return examples
    # the answer index is a function of the question, so a model cannot
    # score above chance without reading it
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(synthetic_examples):
        nums = rng.integers(0, 50, size=2)
        answer = int((nums[0] + nums[1]) % 4)
        choices = [str(int(nums[0] + nums[1] + (j - answer))) for j in range(4)]
        examples.append(MMLUExample(
            "synthetic_arithmetic", f"What is {nums[0]} + {nums[1]}?", tuple(choices), answer))
    return examples


def format_prompt(example: MMLUExample, fewshot: Sequence[MMLUExample] = ()) -> str:
    """The standard MMLU prompt: the k-shot examples, then the question,
    ending in 'Answer:' so that the next token is the answer letter."""

    def one(ex: MMLUExample, with_answer: bool) -> str:
        s = ex.question.strip() + "\n"
        for letter, choice in zip(CHOICES, ex.choices):
            s += f"{letter}. {choice}\n"
        s += "Answer:"
        if with_answer:
            s += f" {CHOICES[ex.answer]}\n\n"
        return s

    subject = example.subject.replace("_", " ")
    header = ("The following are multiple choice questions (with answers) "
              f"about {subject}.\n\n")
    return header + "".join(one(f, True) for f in fewshot) + one(example, False)


def evaluate_mmlu(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    examples: Sequence[MMLUExample],
    tokenize: Callable[[str], List[int]],
    letter_ids: Sequence[int],
    max_len: int = 512,
    batch_size: int = 8,
    fewshot_by_subject: Optional[Dict[str, Sequence[MMLUExample]]] = None,
) -> Dict[str, object]:
    """The choice evaluation. `score_fn(input_ids (B, T) int64, mask (B, T)
    int64) -> (B, V)` final-position logits (`make_choice_score_fn`);
    `letter_ids` the token ids of the four answer letters in CHOICES order.
    Prompts are truncated on the left to `max_len` tokens (keeping the
    question and 'Answer:') and left-padded per batch, so that the final
    position is every row's scoring position. Returns {'accuracy',
    'per_subject', 'n'}."""
    letter_ids = np.asarray(letter_ids, np.int64)
    assert letter_ids.shape == (4,)
    correct: Dict[str, List[bool]] = {}
    for start in range(0, len(examples), batch_size):
        batch = examples[start: start + batch_size]
        toks = []
        for ex in batch:
            shots = fewshot_by_subject.get(ex.subject, ()) if fewshot_by_subject else ()
            toks.append(tokenize(format_prompt(ex, shots))[-max_len:])
        T = max(len(t) for t in toks)
        ids = np.zeros((len(batch), T), np.int64)
        mask = np.zeros((len(batch), T), np.int64)
        for i, t in enumerate(toks):
            ids[i, T - len(t):] = t
            mask[i, T - len(t):] = 1
        logits = score_fn(torch.from_numpy(ids), torch.from_numpy(mask))
        pred = logits.float().cpu().numpy()[:, letter_ids].argmax(-1)
        for ex, p in zip(batch, pred):
            correct.setdefault(ex.subject, []).append(int(p) == ex.answer)
    per_subject = {s: float(np.mean(v)) for s, v in correct.items()}
    flat = [b for v in correct.values() for b in v]
    return {"accuracy": float(np.mean(flat)) if flat else 0.0,
            "per_subject": per_subject, "n": len(flat)}


def make_choice_score_fn(model, benchmarking: bool = False):
    """(ids, mask) -> final-position logits (B, V) of a causal LM (OPT or
    LLaMA) under inference mode, the inputs moved to the model's device.
    Rows are left-padded by `evaluate_mmlu`, so each row's last valid
    position is the final column."""

    def score(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = model(ids.to(model.device), mask.to(model.device), benchmarking=benchmarking)
        return out["logits"][:, -1, :]

    return score


def synthetic_tokenizer(vocab_size: int) -> Callable[[str], List[int]]:
    """Deterministic hash tokenizer for the synthetic task and smoke runs:
    one token per whitespace word, crc32 (not `hash`, which Python salts per
    process) into ids 4 .. vocab_size − 1."""

    def tok(text: str) -> List[int]:
        return [(zlib.crc32(w.encode()) % (vocab_size - 4)) + 4 for w in text.split()]

    return tok


MODELS = ("llama-tiny", "llama-7b", "llama-13b")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama-tiny", choices=MODELS)
    ap.add_argument("--method", default="perlin", choices=("perlin", "none"))
    ap.add_argument("--checkpoint", default=None, help="local HF checkpoint directory")
    ap.add_argument("--data", default=None, help="MMLU CSV directory (hendrycks layout)")
    ap.add_argument("--tokenizer", default=None, help="local HF tokenizer directory")
    ap.add_argument("--fewshot", type=int, default=5)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--benchmarking", action="store_true",
                    help="score through the SEA benchmark path (kernel K1 on the card)")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..models import llama

    builder = {"llama-tiny": llama.llama_tiny, "llama-7b": llama.llama_7b,
               "llama-13b": llama.llama_13b}[args.model]
    model = llama.LlamaForCausalLM(builder(args.method), device=args.device).eval()
    if args.checkpoint:
        from ..models.loader import load_llama_params

        missing, _ = model.load_state_dict(
            load_llama_params(args.checkpoint, model.cfg), strict=False)
        if any(".perlin." not in k for k in missing):
            raise ValueError(f"checkpoint lacks {[k for k in missing if '.perlin.' not in k][:4]}")

    if args.tokenizer:
        from transformers import AutoTokenizer

        tk = AutoTokenizer.from_pretrained(args.tokenizer, local_files_only=True)
        tokenize = lambda s: tk(s, add_special_tokens=True)["input_ids"]  # noqa: E731
        letter_ids = [tk(f" {c}", add_special_tokens=False)["input_ids"][-1] for c in CHOICES]
    else:
        tokenize = synthetic_tokenizer(model.cfg.vocab_size)
        letter_ids = [tokenize(c)[0] for c in CHOICES]

    examples = load_mmlu(args.data, "test")
    if args.limit:
        examples = examples[: args.limit]
    fewshot = None
    if args.fewshot > 0:
        fewshot = {}
        for ex in load_mmlu(args.data, "dev"):
            shots = fewshot.setdefault(ex.subject, [])
            if len(shots) < args.fewshot:
                shots.append(ex)

    res = evaluate_mmlu(
        make_choice_score_fn(model, benchmarking=args.benchmarking), examples, tokenize,
        letter_ids, max_len=args.max_len, batch_size=args.batch_size,
        fewshot_by_subject=fewshot,
    )
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
