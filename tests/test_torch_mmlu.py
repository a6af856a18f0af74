"""Port parity for MMLU scoring: the port's `sea_tpu_torch.data.mmlu` against
the JAX package's `sea_tpu.data.mmlu` on the CPU. Nothing here downloads:
the synthetic task and the hash tokenizer, or CSVs written to `tmp_path`.

What is held, and the tolerance of each:

  * the synthetic examples, `format_prompt` (with and without shots),
    `_read_csv` and `load_mmlu` on a CSV directory, and the tokenizer: equal;
  * `evaluate_mmlu` over `llama_tiny` (weights converted from JAX's, the SEA
    student on the benchmark path and on the dense path): `accuracy`,
    `per_subject` and `n` equal to JAX's, every batch's final-position
    logits within 1e-4 (tests/test_torch_llama.py's bound) and no letter
    pick decided by a margin under that;
  * `main()` with the eval script's flags at `llama-tiny` on the CPU, on the
    synthetic task and on a CSV directory with dev-split shots.
"""

import csv

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.data import mmlu as jm
from sea_tpu.models import llama as jl
from sea_tpu_torch.data import mmlu as tm
from sea_tpu_torch.models import llama as tl
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import torch_llama_config

LOGIT_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_tuple(ex):
    return (ex.subject, ex.question, tuple(ex.choices), ex.answer)


def write_csv(path, rows):
    with open(path, "w", newline="") as fh:
        csv.writer(fh).writerows(rows)


def test_examples_prompts_and_tokenizer_match_jax(tmp_path):
    for seed in (0, 3):
        got = tm.load_mmlu(None, synthetic_examples=24, seed=seed)
        want = jm.load_mmlu(None, synthetic_examples=24, seed=seed)
        assert list(map(as_tuple, got)) == list(map(as_tuple, want))
    shots = tm.load_mmlu(None, synthetic_examples=3, seed=1)
    for ex in got[:4]:
        for k in (0, 2):
            assert tm.format_prompt(ex, shots[:k]) == jm.format_prompt(ex, shots[:k])
    write_csv(tmp_path / "abstract_algebra_test.csv", [
        ["What is 1+1?", "1", "2", "3", "4", "B"],
        ["too short", "1", "2"],
        ["What is 2*3?", "5", "7", "6", "8", " c"],
        ["Bad answer", "1", "2", "3", "4", "E"]])
    (tmp_path / "test").mkdir()
    write_csv(tmp_path / "test" / "law_test.csv", [["Q, with a comma?", "a", "b", "c", "d", "D"]])
    path = str(tmp_path / "abstract_algebra_test.csv")
    assert list(map(as_tuple, tm._read_csv(path, "x"))) == list(map(as_tuple, jm._read_csv(path, "x")))
    got, want = tm.load_mmlu(str(tmp_path)), jm.load_mmlu(str(tmp_path))
    assert len(got) == 3 and list(map(as_tuple, got)) == list(map(as_tuple, want))
    assert [e.subject for e in got] == ["abstract_algebra", "abstract_algebra", "law"]
    text = tm.format_prompt(got[0], got[1:])
    assert tm.synthetic_tokenizer(256)(text) == jm.synthetic_tokenizer(256)(text)


@pytest.mark.parametrize("benchmarking", [True, False], ids=["bench", "dense"])
def test_evaluate_mmlu_matches_jax(benchmarking):
    """16 synthetic examples, 0-shot, batches of 5 (left-padded rows of
    different lengths), through each package's `evaluate_mmlu` and
    `make_choice_score_fn`."""
    cfg = jl.llama_tiny("perlin")
    model = jl.LlamaForCausalLM(cfg)
    ids = jnp.ones((1, 8), jnp.int32)
    variables = jax.jit(lambda: model.init(jax.random.key(0), ids, ids))()
    port = tl.LlamaForCausalLM(torch_llama_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    port.eval()
    examples = tm.load_mmlu(None, synthetic_examples=16)
    tok = tm.synthetic_tokenizer(cfg.vocab_size)
    letters = [tok(c)[0] for c in tm.CHOICES]
    jlogits, tlogits = [], []
    jscore = jm.make_choice_score_fn(model, variables, benchmarking=benchmarking)
    tscore = tm.make_choice_score_fn(port, benchmarking=benchmarking)

    def jax_fn(i, m):
        jlogits.append(np.asarray(jscore(i, m)))
        return jlogits[-1]

    def port_fn(i, m):
        tlogits.append(tscore(i, m))
        return tlogits[-1]

    want = jm.evaluate_mmlu(jax_fn, jm.load_mmlu(None, synthetic_examples=16), tok, letters,
                            batch_size=5, max_len=64)
    got = tm.evaluate_mmlu(port_fn, examples, tok, letters, batch_size=5, max_len=64)
    assert len(tlogits) == len(jlogits) == 4
    for g, w in zip(tlogits, jlogits):
        np.testing.assert_allclose(g.numpy(), w, atol=LOGIT_ATOL)
        top2 = np.sort(w[:, letters], -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > LOGIT_ATOL).all()
    assert got == want and got["n"] == 16


def test_main_runs_on_the_cpu(tmp_path, capsys):
    res = tm.main(["--model", "llama-tiny", "--device", "cpu", "--fewshot", "0",
                   "--limit", "8", "--benchmarking"])
    assert res["n"] == 8 and 0.0 <= res["accuracy"] <= 1.0
    assert set(res["per_subject"]) == {"synthetic_arithmetic"}
    assert '"n": 8' in capsys.readouterr().out
    # a CSV directory with dev-split shots (prompts stay under llama_tiny's
    # 128 positions)
    write_csv(tmp_path / "law_test.csv", [["Q1?", "a", "b", "c", "d", "A"],
                                          ["Q2?", "a", "b", "c", "d", "C"]])
    write_csv(tmp_path / "law_dev.csv", [["S1?", "e", "f", "g", "h", "B"]])
    res = tm.main(["--model", "llama-tiny", "--device", "cpu", "--fewshot", "1",
                   "--data", str(tmp_path), "--method", "none", "--batch-size", "2"])
    assert res["n"] == 2 and set(res["per_subject"]) == {"law"}
