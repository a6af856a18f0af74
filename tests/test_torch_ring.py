"""Port parity: the K/V ring (sea_tpu_torch.parallel.sharded_attention's
`ring_sea_attention` / `ring_fused_train_attention` over a `LocalGroup`, and
the windowed kernels' operands and plain versions in
ops.kernels.block_sparse) against the JAX package's ring over a (dp=2,
sp=4) mesh of the 8 virtual CPU devices, Pallas in interpret mode.

Geometry: N=1, H=2, T=512, D=64, T_M=32, blocks of 64, 4 shards, so every
shard holds 128 rows and every window 128 columns. Tolerances:

  * window operands (bits, row bases, tile lists): exact;
  * plain windowed versions against the JAX windowed kernels: outputs and
    logsumexp 1e-5 abs, gradients 1e-4 abs + 1e-4 rel (the port's tests
    of K2-K4, tests/test_torch_fused_train.py);
  * the ring's forward 1e-5 abs against JAX's ring, 3e-5 against the
    unsharded plain version (the bound of tests/test_sharded_attention.py);
    loss 1e-5 rel and gradients 2e-4 abs against JAX's differentiable ring
    (tests/test_sharded_attention.py:278-313);
  * `DistGroup` over 4 gloo processes against `LocalGroup(4)`: 1e-6 abs;
  * bfloat16 operands: the ring's backward rounds dou to the operands' type
    (JAX's `dou = (do·scaler).astype(q.dtype)`), and the ring's bf16 output
    and gradients lie within 2e-2·max|want| of JAX's bf16 ring (JAX rounds P
    and dS to bf16 before the products, the port's plain versions do not,
    as tests/test_torch_bf16.py holds K2-K4), and no farther from JAX's
    float32 ring on the same bf16 values than JAX's own bf16 ring is, x1.05.

The CUDA kernels K6-K8 are held against the same plain versions on the card,
on every (shard, window), by chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu.parallel import sharded_attention as jsa
from sea_tpu.parallel.mesh import make_mesh
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.parallel import LocalGroup
from sea_tpu_torch.parallel import sharded_attention as tsa
from tests._torch_parity import t

S, T, T_M, B = 4, 512, 32, 64
TL = T // S
FWD_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
RING_GRAD_ATOL = 2e-4


def make_case(seed=0, H=2, density=0.2, empty=(100, 110)):
    """q, k, v, mask, scaler at the ring geometry, with a band of rows whose
    mask is empty."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((1, H, T, 64)) * 0.2).astype(np.float32)
    k = (rng.standard_normal((1, H, T, 64)) * 0.2).astype(np.float32)
    v = rng.standard_normal((1, H, T, 64)).astype(np.float32)
    mask = (rng.uniform(size=(1, H, T, T_M)) < density).astype(np.float32)
    mask[:, :, empty[0]:empty[1]] = 0.0
    scaler = rng.uniform(0.1, 1.0, (1, H, T)).astype(np.float32)
    return q, k, v, mask, scaler


def shard_rows(zigzag):
    """Global row ids in the shards' order: the zigzag permutation or 0..T-1."""
    if zigzag:
        perm = np.asarray(jsa._zigzag_perm(T, S, B))
        np.testing.assert_array_equal(tsa._zigzag_perm(T, S, B).numpy(), perm)
        return perm.astype(np.int32)
    return np.arange(T, dtype=np.int32)


def jax_window_prep(mask_l, rows_l, w):
    """The JAX ring's per-shard prep and window-w lists (sharded_attention.py
    :329-348, :398-403, :517-534), outside shard_map."""
    rows_b = jnp.broadcast_to(jnp.asarray(rows_l)[None, None], mask_l.shape[:3])
    rowbase, act, mbits = jsa._ring_shared_prep(jnp.asarray(mask_l), rows_b, T, T_M, B, B)
    nkw = TL // B
    act_win = act[..., w * nkw:(w + 1) * nkw]
    counts, idx = jb._compact_lists(act_win[:, None])
    counts_t, idx_t = jb._compact_lists(jnp.swapaxes(act_win, -1, -2)[:, None])
    return dict(rowbase=rowbase, mbits=mbits, counts=counts[:, 0],
                idx=idx[:, 0] + w * nkw, counts_t=counts_t[:, 0], idx_t=idx_t[:, 0])


@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_window_operands_match_jax_ring_prep(zigzag):
    """Bits, row bases and every window's lists (global k-block ids forward,
    local q-block ids transposed) of every shard, exactly."""
    _, _, _, mask, _ = make_case()
    rows = shard_rows(zigzag)
    maskp = mask[:, :, rows]
    for p in range(S):
        sl = slice(p * TL, (p + 1) * TL)
        q_l = torch.zeros((1, 2, TL, 64))
        got = tb.window_operands(q_l, t(maskp[:, :, sl]), t(rows[sl]), T, S, B, B)
        for w in range(S):
            want = jax_window_prep(maskp[:, :, sl], rows[sl], w)
            np.testing.assert_array_equal(got.mbits.numpy().view(np.uint32),
                                          np.asarray(want["mbits"]))
            np.testing.assert_array_equal(got.row_base.numpy(), np.asarray(want["rowbase"])[0])
            for name in ("counts", "idx", "counts_t", "idx_t"):
                np.testing.assert_array_equal(getattr(got, name)[w].numpy(),
                                              np.asarray(want[name]),
                                              err_msg=f"shard {p} window {w} {name}")


# (zigzag, shard, window): off-diagonal windows of zigzag rows, a diagonal
# window, and a window wholly past its rows' causal edge (empty)
WINDOWS = [(True, 1, 2), (True, 3, 0), (False, 2, 2), (False, 0, 3)]


@pytest.mark.parametrize("zigzag,shard,window", WINDOWS,
                         ids=[f"{'zz' if z else 'nat'}-s{p}-w{w}" for z, p, w in WINDOWS])
def test_window_references_match_jax_window_kernels(zigzag, shard, window):
    """fwd_stats_window_reference, dq_window_reference and
    dkv_window_reference against JAX's fwd_stats_window, dq_window and
    dkv_window (col_block_base = window · 2), on one shard's rows with the
    rows' total lse (+inf where nothing is alive at all) and a random delta."""
    q, k, v, mask, _ = make_case(seed=1)
    rows = shard_rows(zigzag)
    sl = slice(shard * TL, (shard + 1) * TL)
    ws = slice(window * TL, (window + 1) * TL)
    q_l, mask_l, rows_l = q[:, :, rows][:, :, sl], mask[:, :, rows][:, :, sl], rows[sl]
    k_w, v_w = k[:, :, ws], v[:, :, ws]
    widths = t(rows_l + 1).float()
    _, lse = tb.fwd_with_stats_reference(t(q_l), t(k), t(v), t(mask_l), None, row_widths=widths)
    rng = np.random.default_rng(2)
    dou = rng.standard_normal(q_l.shape).astype(np.float32)
    delta = rng.standard_normal(q_l.shape[:3]).astype(np.float32) * 0.1
    prep = jax_window_prep(mask_l, rows_l, window)
    cb = jnp.asarray([window * (TL // B)], jnp.int32)
    jq, jk, jv = (jnp.asarray(x) for x in (q_l, k_w, v_w))
    kw = dict(t_m=T_M, block_q=B, block_k=B, interpret=True)

    wo, wlse = jb.fwd_stats_window(jq, jk, jv, prep["mbits"], prep["counts"], prep["idx"],
                                   prep["rowbase"], cb, **kw)
    go, glse = tb.fwd_stats_window_reference(t(q_l), t(k_w), t(v_w), t(mask_l),
                                             window * TL, row_widths=widths)
    wlse = np.asarray(wlse).reshape(glse.shape)
    np.testing.assert_array_equal(np.isposinf(wlse), torch.isposinf(glse).numpy())
    fin = np.isfinite(wlse)
    np.testing.assert_allclose(glse.numpy()[fin], wlse[fin], atol=FWD_ATOL)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo).reshape(go.shape), atol=FWD_ATOL)
    if (zigzag, shard, window) == (False, 0, 3):
        assert np.isposinf(wlse).all() and float(go.abs().max()) == 0.0

    jlse, jdelta, jdou = jnp.asarray(lse.numpy()), jnp.asarray(delta), jnp.asarray(dou)
    wdq = jb.dq_window(jq, jk, jv, prep["mbits"], jdou, jlse, jdelta, prep["counts"],
                       prep["idx"], prep["rowbase"], cb, **kw)
    gdq = tb.dq_window_reference(t(q_l), t(k_w), t(v_w), t(mask_l), t(dou), lse, t(delta),
                                 window * TL, row_widths=widths)
    np.testing.assert_allclose(gdq.numpy(), np.asarray(wdq), **GRAD_TOL)
    wdk, wdv = jb.dkv_window(jq, jk, jv, prep["mbits"], jdou, jlse, jdelta,
                             prep["counts_t"], prep["idx_t"], prep["rowbase"], cb, **kw)
    gdk, gdv = tb.dkv_window_reference(t(q_l), t(k_w), t(v_w), t(mask_l), t(dou), lse,
                                       t(delta), window * TL, row_widths=widths)
    np.testing.assert_allclose(gdk.numpy(), np.asarray(wdk), **GRAD_TOL)
    np.testing.assert_allclose(gdv.numpy(), np.asarray(wdv), **GRAD_TOL)


@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_ring_sea_attention_matches_jax(zigzag):
    q, k, v, mask, scaler = make_case()
    mesh = make_mesh(dp=2, sp=4)
    want = jax.jit(lambda *a: jsa.ring_sea_attention(
        *a, mesh=mesh, zigzag=zigzag, block_q=B, block_k=B, interpret=True,
    ))(*(jnp.asarray(x) for x in (q, k, v, mask, scaler)))
    got = tsa.ring_sea_attention(*(t(x) for x in (q, k, v, mask, scaler)), LocalGroup(4),
                                 zigzag=zigzag, block_q=B, block_k=B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    plain = tb.dense_reference(*(t(x) for x in (q, k, v, mask, scaler)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=3e-5)
    assert float(got[:, :, 100:110].abs().max()) == 0.0


def ring_loss_and_grads(q, k, v, mask, scaler, tgt, group, zigzag):
    leaves = [t(x).requires_grad_() for x in (q, k, v, scaler)]
    o = tsa.ring_fused_train_attention(leaves[0], leaves[1], leaves[2], t(mask), leaves[3],
                                       group, zigzag, B, B)
    loss = ((o - t(tgt)) ** 2).sum()
    return (float(loss.detach()), o.detach(), *torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_ring_fused_train_matches_jax(zigzag):
    """Loss and q/k/v/scaler gradients of Σ(o − tgt)² against jax.grad of
    the JAX ring's custom_vjp, as tests/test_sharded_attention.py holds the
    JAX ring against its unsharded kernel."""
    q, k, v, mask, scaler = make_case()
    tgt = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    mesh = make_mesh(dp=2, sp=4)
    jmask = jnp.asarray(mask)

    def jloss(q, k, v, sc):
        o = jsa.ring_fused_train_attention(q, k, v, jmask, sc, mesh, "sp", zigzag, B, B, True)
        return jnp.sum((o - tgt) ** 2)

    wl, wg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(x) for x in (q, k, v, scaler)))
    gl, _, *gg = ring_loss_and_grads(q, k, v, mask, scaler, tgt, LocalGroup(4), zigzag)
    np.testing.assert_allclose(gl, float(wl), rtol=1e-5)
    for a, b, name in zip(gg, wg, ("dq", "dk", "dv", "dscaler")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=RING_GRAD_ATOL, err_msg=name)


def test_ring_empty_rows_and_dead_mask_stay_finite():
    """Rows with nothing alive get a zero output and zero dq/dscaler; a mask
    with nothing alive anywhere gives zeros everywhere and no NaN (the
    merge's ±inf guards)."""
    q, k, v, mask, scaler = make_case(empty=(192, 256))
    tgt = np.zeros(q.shape, np.float32)
    _, o, dq, dk, dv, dsc = ring_loss_and_grads(q, k, v, mask, scaler, tgt, LocalGroup(4), True)
    for x in (o, dq, dk, dv, dsc):
        assert torch.isfinite(x).all()
    assert float(o[:, :, 192:256].abs().max()) == 0.0
    assert float(dq[:, :, 192:256].abs().max()) == 0.0
    assert float(dsc[:, :, 192:256].abs().max()) == 0.0
    leaves = [t(x).requires_grad_() for x in (q, k, v, scaler)]
    o = tsa.ring_fused_train_attention(leaves[0], leaves[1], leaves[2],
                                       torch.zeros(mask.shape), leaves[3], LocalGroup(4))
    grads = torch.autograd.grad((o ** 2).sum() + o.sum(), leaves)
    assert float(o.detach().abs().max()) == 0.0
    for g in grads:
        assert torch.isfinite(g).all() and float(g.abs().max()) == 0.0


def test_ring_bf16_backward_rounds_dou_to_the_operands_type(monkeypatch):
    """The bf16 ring hands `backward_terms` the operands' type, so that dou
    is rounded to bf16 and delta taken from the rounded dou, as JAX's ring
    does; the gradients come back in that type."""
    q, k, v, mask, scaler = make_case()
    seen = []
    terms = tb.backward_terms

    def spy(do, o, sc, dtype):
        seen.append(dtype)
        return terms(do, o, sc, dtype)

    monkeypatch.setattr(tb, "backward_terms", spy)
    leaves = [t(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v, scaler)]
    o = tsa.ring_fused_train_attention(leaves[0], leaves[1], leaves[2], t(mask), leaves[3],
                                       LocalGroup(4), True, B, B)
    grads = torch.autograd.grad((o.float() ** 2).sum(), leaves)
    assert seen == [torch.bfloat16]
    assert o.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in grads)


def test_ring_bf16_matches_jax_bf16_ring():
    """The bf16 ring (zigzag, plain windowed versions) against JAX's bf16
    differentiable ring: output and the q/k/v/scaler gradients of
    Σ(o − tgt)² within 2e-2·max|want|, and no farther from JAX's float32
    ring on the same bf16 values than JAX's bf16 ring is, x1.05."""
    q, k, v, mask, scaler = make_case()
    tgt = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    mesh = make_mesh(dp=2, sp=4)

    def jax_run(dtype):
        def jloss(q, k, v, sc):
            o = jsa.ring_fused_train_attention(q, k, v, jnp.asarray(mask, dtype), sc, mesh,
                                               "sp", True, B, B, True)
            return jnp.sum((o.astype(jnp.float32) - tgt) ** 2), o

        xs = [jnp.asarray(x).astype(jnp.bfloat16).astype(dtype) for x in (q, k, v, scaler)]
        (_, o), g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(*xs)
        return (o, *g)

    want, want32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    leaves = [t(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v, scaler)]
    o = tsa.ring_fused_train_attention(leaves[0], leaves[1], leaves[2],
                                       t(mask).to(torch.bfloat16), leaves[3], LocalGroup(4),
                                       True, B, B)
    got = (o, *torch.autograd.grad(((o.float() - t(tgt)) ** 2).sum(), leaves))

    def f32(x):
        return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(
            jnp.asarray(x).astype(jnp.float32))

    for name, g, w, w32 in zip(("o", "dq", "dk", "dv", "dscaler"), got, want, want32):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert np.isfinite(f32(g)).all(), name
        np.testing.assert_allclose(f32(g), f32(w), atol=2e-2 * float(np.abs(f32(w32)).max()),
                                   rtol=0, err_msg=name)
        own = float(np.abs(f32(w) - f32(w32)).max())
        assert float(np.abs(f32(g) - f32(w32)).max()) <= 1.05 * own, name


_CHILD = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from sea_tpu_torch.parallel import DistGroup
from sea_tpu_torch.parallel import sharded_attention as tsa

init, rank, world, data, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
case = np.load(data)
leaves = [torch.tensor(case[n]).requires_grad_() for n in ("q", "k", "v", "scaler")]
group = DistGroup()
o = tsa.ring_fused_train_attention(leaves[0], leaves[1], leaves[2], torch.tensor(case["mask"]),
                                   leaves[3], group, True, 64, 64)
grads = torch.autograd.grad(((o - torch.tensor(case["tgt"])) ** 2).sum(), leaves)
fwd = tsa.ring_sea_attention(*(torch.tensor(case[n]) for n in ("q", "k", "v", "mask", "scaler")),
                             group, zigzag=False, block_q=64, block_k=64)
np.savez(out, o=o.detach().numpy(), fwd=fwd.numpy(), **{
    n: g.numpy() for n, g in zip(("dq", "dk", "dv", "dscaler"), grads)})
dist.barrier()
dist.destroy_process_group()
print("OK", rank)
"""


def test_dist_group_ring_matches_local_group(tmp_path):
    """The ring's forward (zigzag off) and its differentiable form (zigzag
    on) over `DistGroup`, four gloo processes with one shard each, give
    every process the `LocalGroup(4)` result within 1e-6."""
    q, k, v, mask, scaler = make_case()
    tgt = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    data = tmp_path / "case.npz"
    np.savez(data, q=q, k=k, v=v, mask=mask, scaler=scaler, tgt=tgt)
    _, o, *grads = ring_loss_and_grads(q, k, v, mask, scaler, tgt, LocalGroup(4), True)
    fwd = tsa.ring_sea_attention(*(t(x) for x in (q, k, v, mask, scaler)), LocalGroup(4),
                                 zigzag=False, block_q=B, block_k=B)
    want = dict(o=o, fwd=fwd, **dict(zip(("dq", "dk", "dv", "dscaler"), grads)))

    # rendezvous through a file of this test's own directory: no port that
    # another process could take between choosing it and binding it
    init = (tmp_path / "rendezvous").as_uri()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, init, str(r), str(S), str(data),
             str(tmp_path / f"rank{r}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(S)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a gloo ring process did not finish in 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, out
        got = np.load(tmp_path / f"rank{r}.npz")
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w.numpy(), atol=1e-6,
                                       err_msg=f"rank {r} {name}")


def test_local_group_holds_its_device():
    """A `LocalGroup` on a device splits tensors on that device and refuses
    tensors elsewhere; one with no device takes any."""
    x = torch.arange(16.0).reshape(1, 1, 8, 2)
    parts = LocalGroup(4, "cpu").split_rows(x)
    assert [p.shape[2] for p in parts] == [2] * 4
    assert torch.equal(LocalGroup(4, "cpu").join_rows(parts), x)
    assert len(LocalGroup(2).split_rows(x)) == 2
    with pytest.raises(ValueError, match="given to a group on meta"):
        LocalGroup(4, "meta").split_rows(x)
