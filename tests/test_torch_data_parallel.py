"""Data parallelism of the port's KD trainer (`TrainerConfig.data_parallel`,
over `parallel.mesh`'s 'dp' axis) and `WindowedCorpus.batches`' shards.

Two gloo processes, each with a 120 s limit, run two updates of the tiny KD
trainer on global batches whose two rows hold different counts of
supervised targets (a first strided window supervises all of its tokens,
a later one only its last `stride`); their parameters must come within
1e-6 of max|p| of one process's on the same batches (the ranks sum their
gradients in another order), and their evaluation within 1e-6 relative. In
one process `data_parallel` changes nothing, bit for bit. The shards of
`batches` are JAX's windows.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sea_tpu.data import wikitext2 as jw
from sea_tpu_torch.data import wikitext2 as tw
from sea_tpu_torch.training import opt_trainer as to

WORLD = 2
GRAD_REL = 1e-5  # of the largest gradient of the update (float32 sums reordered)
TERM_REL = 1e-5
EVAL_REL = 1e-6
# the global batches' windows: row 0 a first window (every target
# supervised), row 1 a later one (its last `stride` targets only)
BATCH_WINDOWS = ((0, 5), (3, 0))


@pytest.fixture
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def dp_cfg(save_dir, **kw):
    base = dict(model="tiny", max_seq_len=64, stride=32, batch_size=WORLD,
                gradient_accumulation_steps=2, num_steps=10, eval_steps=1000, log_steps=1,
                save_dir=str(save_dir), data_parallel=True)
    base.update(kw)
    return to.TrainerConfig(**base)


def global_batch(corpus, windows):
    ids = np.full((len(windows), corpus.max_length), 1, np.int32)
    mask = np.zeros_like(ids)
    labels = np.full(ids.shape, -100, np.int64)
    for j, w in enumerate(windows):
        x, lab = corpus.window(w)
        ids[j, :len(x)], mask[j, :len(x)], labels[j, :len(lab)] = x, 1, lab
    return ids, mask, labels


def capture_updates(tr):
    """Record, at each optimizer step, the parameters it starts from and the
    gradients it is handed (under data_parallel: reduced over the ranks)."""
    seen = []
    step = tr.optimizer.step

    def recording_step():
        named = list(tr.student.named_parameters())
        seen.append(({n: p.detach().clone() for n, p in named},
                     {n: p.grad.detach().clone() for n, p in named}))
        return step()

    tr.optimizer.step = recording_step
    return seen


def update(tr):
    """One update of two micro-steps over BATCH_WINDOWS' batches; returns
    the logged terms of the last micro-step."""
    for windows in BATCH_WINDOWS:
        details = tr.micro_step(*global_batch(tr.corpus, windows))
    tr.update()
    return {k: float(v) for k, v in details.items()}


def two_updates(tr):
    update(tr)
    return update(tr)


_CHILD = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from tests import test_torch_data_parallel as T
from sea_tpu_torch.training import opt_trainer as to

init, rank, world, save_dir, scan_kd, out = sys.argv[1:7]
rank, world, scan_kd = int(rank), int(world), scan_kd == "1"
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
tr = to.OptTrainer(T.dp_cfg(save_dir, scan_kd=scan_kd), device="cpu")
assert tr.dp is not None and tr.dp.size == world
seen = T.capture_updates(tr)
terms = [T.update(tr) for _ in range(2)]
ppl = tr.evaluate(max_batches=2)
arrays = {f"{kind}{u}.{n}": x.numpy() for u, pair in enumerate(seen)
          for kind, tensors in zip("pg", pair) for n, x in tensors.items()}
arrays.update({f"final.{n}": p.detach().numpy() for n, p in tr.student.named_parameters()})
np.savez(out, **arrays)
with open(out + ".json", "w") as f:
    json.dump({"terms": terms, "ppl": ppl, "step": tr.step, "writer": tr.is_writer}, f)
dist.barrier()
dist.destroy_process_group()
print("OK", rank)
"""


def run_ranks(tmp_path, scan_kd):
    """The two gloo processes; returns each rank's arrays and record."""
    init = (tmp_path / "rendezvous").as_uri()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, init, str(r), str(WORLD), str(tmp_path / "dp"),
             str(int(scan_kd)), str(tmp_path / f"rank{r}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root,
        )
        for r in range(WORLD)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a gloo data-parallel process did not finish in 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, out
        with open(tmp_path / f"rank{r}.npz.json") as f:
            ranks.append((dict(np.load(tmp_path / f"rank{r}.npz")), json.load(f)))
    return ranks


@pytest.mark.parametrize("scan_kd", [False, True], ids=["loop", "scan_kd"])
def test_two_gloo_processes_match_one_process(tmp_path, one_torch_thread, scan_kd):
    """Two updates over two gloo ranks. Both ranks hand the optimizer the
    same reduced gradients and end with the same parameters, bit for bit;
    each update's gradients equal one process's on the global batches at
    the same parameters within GRAD_REL of the largest; the logged terms and
    the evaluation are the global batch's."""
    (got, rec), (got1, rec1) = run_ranks(tmp_path, scan_kd)
    assert got.keys() == got1.keys() and all(np.array_equal(got[k], got1[k]) for k in got)
    assert rec["step"] == rec1["step"] == 2 and rec["writer"] and not rec1["writer"]
    assert rec["terms"] == rec1["terms"] and rec["ppl"] == rec1["ppl"]

    one = to.OptTrainer(dp_cfg(tmp_path / "one", scan_kd=scan_kd, data_parallel=False),
                        device="cpu")
    # the ranks' shares of supervised targets differ, so a plain mean of
    # their cross entropies would be wrong
    for windows in BATCH_WINDOWS:
        counts = (global_batch(one.corpus, windows)[2][:, 1:] != -100).sum(1)
        assert counts[0] != counts[1], counts
    seen = capture_updates(one)

    def load(prefix):
        with torch.no_grad():
            for n, p in one.student.named_parameters():
                p.copy_(torch.from_numpy(got[f"{prefix}.{n}"]))

    for u in range(2):
        # one process's update u from the ranks' parameters before it (its
        # generator has drawn the same jitter as theirs)
        load(f"p{u}")
        terms = update(one)
        for name, v in terms.items():
            np.testing.assert_allclose(rec["terms"][u][name], v, rtol=TERM_REL,
                                       err_msg=f"update {u} {name}")
        want = seen[u][1]
        scale = max(float(g.abs().max()) for g in want.values())
        for n, w in want.items():
            np.testing.assert_allclose(got[f"g{u}.{n}"], w.numpy(), rtol=0,
                                       atol=GRAD_REL * scale, err_msg=f"update {u} {n}")
    load("final")
    np.testing.assert_allclose(rec["ppl"], one.evaluate(max_batches=2), rtol=EVAL_REL)


@pytest.mark.parametrize("model", ["tiny", "llama-tiny"])
def test_one_process_is_unchanged(tmp_path, one_torch_thread, model):
    """One process: `data_parallel=True` takes no group and its updates and
    evaluation equal the default trainer's bit for bit."""
    runs = []
    for dp in (False, True):
        tr = to.OptTrainer(dp_cfg(tmp_path / str(dp), model=model, data_parallel=dp),
                           device="cpu")
        assert tr.dp is None and tr.is_writer
        terms = two_updates(tr)
        runs.append((terms, tr.evaluate(max_batches=2), tr.student.state_dict()))
    (t0, e0, s0), (t1, e1, s1) = runs
    assert t0 == t1 and e0 == e1
    assert all(torch.equal(s0[n], s1[n]) for n in s0)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_batches_shards_match_jax(shuffle, num_shards):
    """Shard `shard_id` of `num_shards` deals JAX's windows, round-robin
    over the (shuffled) order, batch for batch."""
    tokens = jw.synthetic_corpus(vocab_size=256, total_tokens=2000, seed=3)
    want_c = jw.WindowedCorpus(tokens, max_length=64, stride=32)
    got_c = tw.WindowedCorpus(tokens, max_length=64, stride=32)
    for shard in range(num_shards):
        want = list(want_c.batches(3, shuffle=shuffle, seed=11, shard_id=shard,
                                   num_shards=num_shards))
        got = list(got_c.batches(3, shuffle=shuffle, seed=11, shard_id=shard,
                                 num_shards=num_shards))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, np.asarray(b))
