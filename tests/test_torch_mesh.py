"""Port parity: the (dp, sp) mesh and its sharding rules (sea_tpu_torch.
parallel.mesh against sea_tpu.parallel.mesh on the 8 virtual CPU devices),
and the scaling sweep over LocalGroup meshes (sea_tpu_torch.benchmarks.
scaling_sweep against the JAX sweep's configuration and forward).

The sweep's forward is held within 2e-5 abs: sharded against unsharded (the
same plain K1 arithmetic per row, its rows cut into shards) and against JAX's
jitted forward (Pallas in interpret mode, tests/test_parallel.py's bound);
its compressed masks exactly.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig as JaxSeaConfig
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.parallel import mesh as jmesh
from sea_tpu_torch import benchmarks as tbench
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.parallel import (
    LocalGroup,
    batch_sharding,
    make_mesh,
    opt_state_sharding,
    param_sharding,
    replicated,
    sharded_attention_scope,
)
from sea_tpu_torch.training import opt_trainer as to
from tests._torch_parity import jax_variables_from_state_dict, port_topk_guard, torch_sea_config

CTX_ATOL = 2e-5
CPUS = ["cpu"] * 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec(sharding) -> tuple:
    """A JAX NamedSharding's spec as the port writes it."""
    return tuple(sharding.spec)


def test_mesh_shapes_match_jax():
    """tests/test_parallel.py:14-18 on both sides: (2, 4) as asked, and the
    default over 8 positions sp = 4, dp = 2; a size alone fixes the other;
    each axis is a LocalGroup of its size."""
    mesh = make_mesh(dp=2, sp=4, devices=CPUS)
    assert mesh.shape == {"dp": 2, "sp": 4} == dict(jmesh.make_mesh(dp=2, sp=4).shape)
    mesh = make_mesh(devices=CPUS)
    assert mesh.size == 8 and mesh.shape == dict(jmesh.make_mesh().shape)
    for dp, sp in ((None, 2), (8, None), (1, 8)):
        got, want = make_mesh(dp, sp, devices=CPUS), jmesh.make_mesh(dp, sp)
        assert got.shape == dict(want.shape)
        for axis in ("dp", "sp"):
            group = got.group(axis)
            assert isinstance(group, LocalGroup) and group.size == got.shape[axis]
    with pytest.raises(AssertionError):
        make_mesh(dp=3, sp=2, devices=CPUS)
    with pytest.raises(ValueError):
        make_mesh(dp=1, sp=2, devices=["cpu", "meta"])


@pytest.mark.parametrize("dp,sp", [(2, 4), (4, 2), (8, 1)])
def test_sharding_rules_match_jax(tmp_path, dp, sp):
    """`opt_state_sharding` over the tiny KD trainer's GroupedAdamW moments
    (and the step count), leaf for leaf, against JAX's rule on arrays of the
    same shapes; `batch_sharding`, `replicated` and `param_sharding` as
    JAX's."""
    mesh, jm = make_mesh(dp, sp, devices=CPUS), jmesh.make_mesh(dp, sp)
    tr = to.OptTrainer(to.TrainerConfig(model="tiny", max_seq_len=64, stride=32,
                                        save_dir=str(tmp_path)), device="cpu")
    state = tr.optimizer.state_dict()
    jstate = {"count": jnp.zeros((), jnp.int32),
              "state": {n: {m: jnp.zeros(tuple(x.shape)) for m, x in moments.items()}
                        for n, moments in state["state"].items()}}
    got = opt_state_sharding(mesh, tr.optimizer)
    want = jmesh.opt_state_sharding(jm, jstate)
    assert got["count"].spec == spec(want["count"]) == ()
    sharded = 0
    for n, moments in state["state"].items():
        for m in moments:
            assert got["state"][n][m].spec == spec(want["state"][n][m]), (n, m)
            assert got["state"][n][m].mesh is mesh
            sharded += got["state"][n][m].spec == ("dp",)
    assert 0 < sharded < 2 * len(state["state"])
    assert batch_sharding(mesh).spec == spec(jmesh.batch_sharding(jm)) == ("dp", "sp")
    assert replicated(mesh).spec == spec(jmesh.replicated(jm)) == ()
    params = param_sharding(mesh, tr.student)
    assert set(params) == {n for n, _ in tr.student.named_parameters()}
    assert all(s.spec == () for s in params.values())


def test_scaling_sweep_records():
    """The port of tests/test_parallel.py:79-88: the sweep at 1, 2, 4 and 8
    LocalGroup positions gives finite rates and names the 'seq' kernel."""
    res = tbench.scaling_sweep(device_counts=[1, 2, 4, 8], device="cpu")
    assert [r["devices"] for r in res] == [1, 2, 4, 8]
    for r in res:
        assert r["nnz_per_s"] > 0 and np.isfinite(r["nnz_per_s"]) and np.isfinite(r["ms"])
        assert "seq fused kernel" in r["mesh"] and "not scaling" in r["positions"]
    assert res[0]["scaling_eff"] == 1.0
    # the JAX sweep's skip: no shard below 128 rows
    assert [r["devices"] for r in tbench.scaling_sweep([16], device="cpu")] == []


def test_scaling_forward_matches_jax_and_unsharded():
    """The sweep's configuration and input as JAX's; its forward under
    'seq' over 4 positions within 2e-5 of the unsharded one and of JAX's
    jitted forward from the same weights, the compressed masks equal."""
    cfg, q, causal = tbench.scaling_inputs("cpu")
    # sea_tpu/benchmarks.py:202-206
    jcfg = JaxSeaConfig(num_heads=4, head_dim=32, predictor_length=32, k=8,
                        performer_nb_factor=1, causal=True, max_position_embeddings=1024,
                        use_pallas=True).validate()
    assert cfg == torch_sea_config(jcfg)
    rng = np.random.default_rng(0)
    want_q = rng.standard_normal((1, 4, 1024, 32)).astype(np.float32) * 0.3
    np.testing.assert_array_equal(q.numpy(), want_q)
    model = SeaAttention(cfg, device="cpu", seed=0)
    ctx, mask_m = port_topk_guard(lambda: tbench.scaling_forward(model, q, causal))
    with sharded_attention_scope(make_mesh(dp=1, sp=4, devices=["cpu"] * 4), axis="sp",
                                 kind="seq"):
        ctx_sharded, mask_sharded = tbench.scaling_forward(model, q, causal)
    np.testing.assert_array_equal(mask_sharded.numpy(), mask_m.numpy())
    np.testing.assert_allclose(ctx_sharded.numpy(), ctx.numpy(), atol=CTX_ATOL, rtol=0)

    jmodel = JaxSeaAttention(jcfg)
    jq, jc = jnp.asarray(q.numpy()), jnp.asarray(causal.numpy())
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jq, jq, jq, jq, jq, jq, jq, jq, jc)
    variables = jax_variables_from_state_dict(shapes, model.state_dict())

    @jax.jit
    def fwd(v, x, m):
        out = jmodel.apply(v, x, x, x, x, x, x, x, x, m, benchmarking=True)
        return out.context_layer, out.partial_attention_mask

    want_ctx, want_mask = fwd(variables, jq, jc)
    np.testing.assert_array_equal(mask_m.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=CTX_ATOL, rtol=0)
    np.testing.assert_allclose(ctx_sharded.numpy(), np.asarray(want_ctx), atol=CTX_ATOL,
                               rtol=0)


_CHILD = r"""
import sys
import torch
import torch.distributed as dist
from sea_tpu_torch.parallel import DistGroup, make_mesh

init, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
mesh = make_mesh(dp=2, sp=2)
assert mesh.shape == {"dp": 2, "sp": 2}
assert mesh.devices.tolist() == [[0, 1], [2, 3]]
for axis, want in (("sp", [1, 1, 5, 5]), ("dp", [2, 4, 2, 4])):
    g = mesh.group(axis)
    assert isinstance(g, DistGroup) and g.size == 2
    total = g.all_reduce_sum([torch.tensor([float(rank)])])
    assert int(total) == want[rank], (axis, rank, int(total))
    rows = g.split_rows(torch.arange(4.0)[None, None, :], 2)[0]
    assert rows.tolist() == [[[2.0 * g.rank, 2.0 * g.rank + 1]]], rows
dist.barrier()
dist.destroy_process_group()
print("OK", rank)
"""


def test_mesh_over_processes(tmp_path):
    """Four gloo processes (each with a 120 s limit) build the (2, 2) mesh:
    rank r at (r // 2, r % 2), its 'sp' group its row and its 'dp' group its
    column, each a DistGroup of its two processes."""
    init = (tmp_path / "rendezvous").as_uri()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, init, str(r), "4"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a gloo mesh process did not finish in 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, out
