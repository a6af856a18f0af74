"""The port's multi-position dry run (sea_tpu_torch.dryrun, the port of
`__graft_entry__.dryrun_multichip`) on the CPU over LocalGroup positions,
and tensor and pipeline parallelism over real processes: two gloo ranks
(DistGroup) against one process.

The dry run's sections assert JAX's own bounds (1e-4 on logits and losses,
2e-4 on gradients, identical tokens); the two ranks' TP forward and
gradients, PP forward and gradients, and 1F1B KD gradients must equal one
process's within 1e-5.
"""

import os
import subprocess
import sys

import pytest
import torch

from sea_tpu_torch.dryrun import dryrun_multichip

SECTIONS = (
    "mesh=dp4xsp2", "sharded benchmark forward", "tensor-parallel forward",
    "TP x fused benchmark", "sequence-sharded differentiable fused train",
    "RING differentiable fused train", "pipeline-parallel fwd+bwd", "interleaved pipeline",
    "KD through the pipeline", "KD on the true 1F1B schedule", "head-sharded serving engine",
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_cpu(capsys):
    """`dryrun_multichip(8, "cpu")`: one line a section of JAX's dry run,
    each ending OK (a section that misses its bound raises)."""
    dryrun_multichip(8, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(SECTIONS)
    for line, section in zip(lines, SECTIONS):
        assert line.startswith("dryrun_multichip(8): ") and section in line, line
        assert line.endswith("OK"), line


def test_dryrun_small_meshes(capsys):
    """Fewer positions run fewer sections, as JAX's: 2 (dp1 x sp2: no
    pipeline) and 1 (no tensor parallelism, no engine)."""
    dryrun_multichip(2, device="cpu")
    assert len(capsys.readouterr().out.strip().splitlines()) == 7
    dryrun_multichip(1, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[0].startswith(
        "dryrun_multichip(1): mesh=dp1xsp1")


_CHILD = r"""
import dataclasses, sys
import torch
import torch.distributed as dist
from sea_tpu_torch.config import SeaConfig
from sea_tpu_torch.models.opt import OptConfig, OptForCausalLM, cross_entropy_shifted
from sea_tpu_torch.parallel import DistGroup
from sea_tpu_torch.parallel.pp import (make_pp_mesh, pp_causal_lm_forward,
                                       pp_kd_1f1b_value_and_grad, pp_kd_loss)
from sea_tpu_torch.parallel.tp import gather_tp, make_tp_mesh, tensor_parallel

init, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
torch.set_num_threads(1)
sea = SeaConfig(num_heads=2, head_dim=8, predictor_length=8, k=2, performer_nb_factor=1,
                causal=True, max_position_embeddings=64).validate()
cfg = OptConfig(vocab_size=128, hidden_size=16, num_layers=2, num_heads=2, ffn_dim=32,
                max_position_embeddings=64, sea=sea)
ids = torch.randint(4, 128, (4, 16), generator=torch.Generator().manual_seed(0))
mask = torch.ones_like(ids)


def grads(m):
    return {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}


def err(a, b):
    return float((a.detach() - b.detach()).abs().max())


def mine(n):
    # a process holds its stage's layers' gradients; stage 0's process also
    # the replicated parameters' (the embedding's input path runs there)
    return n.startswith(f"model.layers.{rank}.") or (rank == 0 and "layers" not in n)


ref = OptForCausalLM(cfg, device="cpu", seed=0)
with torch.no_grad():
    bench = ref(ids, mask, benchmarking=True)["logits"]
want = ref(ids, mask)["logits"]
cross_entropy_shifted(want, ids).backward()
g_ref = grads(ref)

tp = tensor_parallel(OptForCausalLM(cfg, device="cpu", seed=0), make_tp_mesh(dp=1, tp=2))
assert isinstance(tp.tp_group, DistGroup) and len(tp.model.layers[0].fc1.weight) == 1
with torch.no_grad():
    errs = {"tp benchmark": err(tp(ids, mask, benchmarking=True)["logits"], bench)}
out = tp(ids, mask)["logits"]
errs["tp forward"] = err(out, want)
cross_entropy_shifted(out, ids).backward()
g_tp = gather_tp(tp, grads=True)
errs["tp grads"] = max(err(g_tp[n], g) for n, g in g_ref.items())

mesh = make_pp_mesh(dp=1, pp=2)
pm = OptForCausalLM(cfg, device="cpu", seed=0)
logits, _ = pp_causal_lm_forward(pm, ids, mask, mesh=mesh, num_microbatches=2)
errs["pp forward"] = err(logits, want)
cross_entropy_shifted(logits, ids).backward()
errs["pp grads"] = max(err(p.grad, g_ref[n]) for n, p in pm.named_parameters()
                       if n in g_ref and mine(n))

t = OptForCausalLM(dataclasses.replace(cfg, attention_method="none"), device="cpu", seed=1)
s = OptForCausalLM(cfg, device="cpu", seed=2)
loss, _ = pp_kd_loss(t, s, ids, mask, ids, mesh=mesh, num_microbatches=2)
loss.backward()
g_kd = grads(s)
loss_1f1b, _, d = pp_kd_1f1b_value_and_grad(t, s, ids, mask, ids, mesh=mesh, num_microbatches=2)
errs["1f1b loss"] = err(loss_1f1b, loss)
errs["1f1b grads"] = max(err(d[n], g) for n, g in g_kd.items() if mine(n))
print("ERRS", rank, errs)
assert max(errs.values()) < 1e-5, errs
dist.barrier()
dist.destroy_process_group()
print("OK", rank)
"""


def test_tp_and_pp_over_processes(tmp_path):
    """Two gloo processes (each with a 120 s limit): the tiny OPT tensor
    parallel over them (tp = 2: the benchmark and dense forwards, the task
    gradients joined by `gather_tp`) and pipelined over them (pp = 2: GPipe's
    forward and task gradients, KD on GPipe and on 1F1B), each within 1e-5
    of one process's unsharded model or of GPipe."""
    init = (tmp_path / "rendezvous").as_uri()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, init, str(r), "2"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a gloo process did not finish in 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, out
