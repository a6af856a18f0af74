"""The multi-position dry run (port of `__graft_entry__.dryrun_multichip`).

`dryrun_multichip(n, device)` lays n mesh positions over one device as
`LocalGroup`s (the JAX tests' virtual devices are one process's too) and
runs each of the JAX dry run's sections once, at its tiny shapes, each
against its unsharded counterpart within JAX's own bound: 1e-4 on logits and
losses, 2e-4 on gradients, identical tokens. One printed line a section:

  * the KD training step over a (dp, sp) mesh with the ZeRO-1 rule for the
    optimizer's moments;
  * the sharded benchmark path ('seq' kind over sp);
  * the tensor-parallel forward, and TP × the fused benchmark path (K1 on
    each position's heads);
  * the sequence-sharded differentiable fused train step, and the ring;
  * the pipeline's forward and backward (GPipe), and the interleaved
    pipeline;
  * KD through the pipeline, and KD on the 1F1B schedule, each with one
    optimizer update;
  * the head-sharded serving engine.

JAX's shapes have heads of 8, which the card's kernels do not take: the
heads are 8 wide on the CPU (plain versions) and 64 on the card, the
smallest width every kernel of these paths (K1-K4, K6-K8) takes.

    python -c "from sea_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(8, 'cpu')"
"""

from __future__ import annotations

import copy
import dataclasses
import torch

from .config import SeaConfig
from .models.opt import OptConfig, OptForCausalLM, cross_entropy_shifted
from .parallel import LocalGroup, make_mesh, opt_state_sharding, sharded_attention_scope
from .parallel.pp import (make_pp_mesh, pp_causal_lm_forward, pp_kd_1f1b_value_and_grad,
                          pp_kd_loss)
from .parallel.tp import make_tp_mesh, tensor_parallel
from .serving import ServingEngine
from .training.distill import SeaOptKD
from .training.optimizer import GroupedAdamW


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _grad_err(a: dict, b: dict) -> float:
    if set(a) != set(b):
        raise AssertionError(f"gradients of other parameters: {sorted(set(a) ^ set(b))}")
    return max(_max_err(a[n], b[n]) for n in a)


def _global_norm(grads) -> float:
    return float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))


def _moved(model, before: dict) -> float:
    return _global_norm([p.detach() - before[n] for n, p in model.named_parameters()])


def _spec_leaves(tree) -> list:
    """The specs of a sharding tree's leaves."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    return [tree.spec]


def _snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    device = torch.device(device)
    dev = [device] * n_devices
    head_dim = 64 if device.type == "cuda" else 8
    tag = f"dryrun_multichip({n_devices})"
    sp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // sp
    mesh = make_mesh(dp=dp, sp=sp, devices=dev)

    sea = SeaConfig(num_heads=2, head_dim=head_dim, predictor_length=8, k=2,
                    performer_nb_factor=1, causal=True, max_position_embeddings=64).validate()
    cfg_kw = dict(vocab_size=128, hidden_size=2 * head_dim, num_layers=2, num_heads=2,
                  ffn_dim=4 * head_dim, max_position_embeddings=64, sea=sea)
    t_cfg = OptConfig(attention_method="none", **cfg_kw)
    s_cfg = OptConfig(attention_method="perlin", **cfg_kw)

    N, T = max(2, dp), 32
    ids = torch.ones((N, T), dtype=torch.int64, device=device)
    amask = torch.ones_like(ids)
    labels = torch.ones_like(ids)

    # --- the KD step over (dp, sp), the ZeRO-1 rule for the moments -------
    kd = SeaOptKD(OptForCausalLM(t_cfg, device=device, seed=0),
                  OptForCausalLM(s_cfg, device=device, seed=1))
    opt = GroupedAdamW(kd.student, lr=1e-4)
    specs = _spec_leaves(opt_state_sharding(mesh, opt))
    sharded = sum(spec == ("dp",) for spec in specs)
    assert 0 < sharded < len(specs), (sharded, len(specs))
    loss, _ = kd.kd_loss(ids, amask, labels)
    loss.backward()
    loss = loss.detach()
    before = _snapshot(kd.student)
    opt.step()
    assert torch.isfinite(loss), float(loss)
    assert _moved(kd.student, before) > 0
    print(f"{tag}: mesh=dp{dp}xsp{sp} loss={float(loss):.4f} ZeRO-1 state leaves over dp "
          f"{sharded}/{len(specs)} OK")

    # --- the sharded sparse benchmark path through the model --------------
    if sp > 1:
        Tb = 128 * sp  # one 128-row kernel block per sequence shard
        sea_b = dataclasses.replace(sea, max_position_embeddings=Tb)
        b_cfg = dataclasses.replace(s_cfg, sea=sea_b, max_position_embeddings=Tb)
        bench = OptForCausalLM(b_cfg, device=device, seed=2)
        ids_b = torch.ones((1, Tb), dtype=torch.int64, device=device)
        with torch.no_grad():
            plain = bench(ids_b, torch.ones_like(ids_b), benchmarking=True)["logits"]
            with sharded_attention_scope(mesh, axis="sp", kind="seq"):
                got = bench(ids_b, torch.ones_like(ids_b), benchmarking=True)["logits"]
        err = _max_err(plain, got)
        assert err < 1e-4, f"sharded benchmark path mismatch: {err}"
        print(f"{tag}: sharded benchmark forward (sp={sp}, zigzag fused kernel) "
              f"max|Δ|={err:.2e} OK")

    # --- tensor parallelism ------------------------------------------------
    if n_devices >= 2:
        tp_mesh = make_tp_mesh(dp=n_devices // 2, tp=2, devices=dev)
        tp_ref = OptForCausalLM(s_cfg, device=device, seed=3)
        tp_model = tensor_parallel(copy.deepcopy(tp_ref), tp_mesh)
        with torch.no_grad():
            ref = tp_ref(ids[:1], amask[:1])["logits"]
            got = tp_model(ids[:1], amask[:1])["logits"]
        err = _max_err(ref, got)
        assert err < 1e-4, f"tensor-parallel forward mismatch: {err}"
        print(f"{tag}: tensor-parallel forward (tp=2 Megatron shardings) max|Δ|={err:.2e} OK")
        with torch.no_grad():
            ref = tp_ref(ids[:1], amask[:1], benchmarking=True)["logits"]
            got = tp_model(ids[:1], amask[:1], benchmarking=True)["logits"]
        err = _max_err(ref, got)
        assert err < 1e-4, f"TP fused benchmark mismatch: {err}"
        print(f"{tag}: TP x fused benchmark (head-sharded kernel over tp) max|Δ|={err:.2e} OK")
        del tp_ref, tp_model

        # the sequence-sharded differentiable fused kernel, and the ring
        if sp > 1:
            Tf = 128 * sp
            sea_f = dataclasses.replace(sea, max_position_embeddings=Tf, use_fused_train=True)
            f_model = OptForCausalLM(dataclasses.replace(s_cfg, sea=sea_f,
                                                         max_position_embeddings=Tf),
                                     device=device, seed=7)
            ids_f = torch.ones((1, Tf), dtype=torch.int64, device=device)

            def f_step():
                f_model.zero_grad()
                out = f_model(ids_f, torch.ones_like(ids_f), labels=ids_f, training=True)
                out["loss"].backward()
                return out["loss"].detach(), _grads(f_model)

            l_plain, g_plain = f_step()
            for kind, label in (("seq", "sequence-sharded differentiable fused train "
                                        f"(sp={sp}, row_base backward)"),
                                ("ring", f"RING differentiable fused train (sp={sp}, "
                                         "K/V+dk/dv sharded)")):
                with sharded_attention_scope(mesh, axis="sp", kind=kind, block_q=128,
                                             block_k=128):
                    l_sh, g_sh = f_step()
                derr, gerr = _max_err(l_plain, l_sh), _grad_err(g_plain, g_sh)
                assert derr < 1e-4 and gerr < 2e-4, (kind, derr, gerr)
                print(f"{tag}: {label} |Δloss|={derr:.2e} max|Δg|={gerr:.2e} OK")
            del f_model

    # --- pipeline parallelism ------------------------------------------------
    if n_devices >= 4:
        pp = 4
        pp_mesh = make_pp_mesh(dp=n_devices // pp, pp=pp, devices=dev)
        pp_cfg = dataclasses.replace(s_cfg, num_layers=pp)
        model = OptForCausalLM(pp_cfg, device=device, seed=4)
        with torch.no_grad():
            ref = model(ids, amask)["logits"]
        logits, _ = pp_causal_lm_forward(model, ids, amask, mesh=pp_mesh, num_microbatches=2)
        loss_pp = cross_entropy_shifted(logits, labels)
        loss_pp.backward()
        loss_pp = loss_pp.detach()
        err = _max_err(ref, logits)
        assert err < 1e-4, f"pipeline-parallel forward mismatch: {err}"
        g_pp = _grads(model)
        model.zero_grad()
        cross_entropy_shifted(model(ids, amask)["logits"], labels).backward()
        gerr = _grad_err(g_pp, _grads(model))
        gnorm = _global_norm(g_pp.values())
        assert gerr < 2e-4 and gnorm == gnorm, (gerr, gnorm)
        print(f"{tag}: pipeline-parallel fwd+bwd (pp={pp}, GPipe) max|Δ|={err:.2e} "
              f"loss={float(loss_pp):.4f} |g|={gnorm:.3f} max|Δg|={gerr:.2e} OK")

        il_mesh = make_pp_mesh(dp=n_devices // 2, pp=2, devices=dev)
        with torch.no_grad():
            out_il, _ = pp_causal_lm_forward(model, ids, amask, mesh=il_mesh,
                                             num_microbatches=2, interleave=2)
        err_il = _max_err(ref, out_il)
        assert err_il < 1e-4, f"interleaved pipeline mismatch: {err_il}"
        print(f"{tag}: interleaved pipeline (pp=2, V=2 chunks/stage) max|Δ|={err_il:.2e} OK")
        del model

        # KD through the pipeline, composed with dp, one optimizer update
        pp_t_cfg = dataclasses.replace(t_cfg, num_layers=pp)
        teacher = OptForCausalLM(pp_t_cfg, device=device, seed=5)
        student = OptForCausalLM(pp_cfg, device=device, seed=6)
        dp_axis = "dp" if n_devices // pp > 1 else None
        kd_ref = SeaOptKD(teacher, student)
        with torch.no_grad():
            loss_ref = kd_ref.kd_loss(ids, amask, labels)[0]
        start = _snapshot(student)
        loss_kd, _ = pp_kd_loss(teacher, student, ids, amask, labels, mesh=pp_mesh,
                                num_microbatches=1, dp_axis=dp_axis)
        loss_kd.backward()
        loss_kd = loss_kd.detach()
        g_kd = _grads(student)
        opt = GroupedAdamW(student, lr=1e-4)
        opt.step()
        derr = _max_err(loss_kd, loss_ref)
        gnorm_kd = _global_norm(g_kd.values())
        moved = _moved(student, start)
        assert derr < 1e-4, f"pp KD loss mismatch: {derr}"
        assert gnorm_kd == gnorm_kd and moved > 0, (gnorm_kd, moved)
        print(f"{tag}: KD through the pipeline (pp={pp} x dp{n_devices // pp}, stage-local "
              f"captures) |loss-ref|={derr:.2e} |g|={gnorm_kd:.3f} OK")

        # KD on the 1F1B schedule, from the same parameters: its gradients
        # against GPipe's just above, then an update
        with torch.no_grad():
            for n, p in student.named_parameters():
                p.copy_(start[n])
        student.zero_grad()
        loss_1f1b, _, d_s = pp_kd_1f1b_value_and_grad(
            teacher, student, ids, amask, labels, mesh=pp_mesh, num_microbatches=1,
            dp_axis=dp_axis)
        derr2 = _max_err(loss_1f1b, loss_ref)
        gerr = _grad_err({n: g for n, g in d_s.items() if n in g_kd}, g_kd)
        assert derr2 < 1e-4, f"1F1B KD loss mismatch: {derr2}"
        assert gerr < 1e-4, f"1F1B KD grads != GPipe KD grads: {gerr}"
        for n, p in student.named_parameters():
            p.grad = d_s.get(n)
        opt = GroupedAdamW(student, lr=1e-4)
        opt.step()
        moved = _moved(student, start)
        assert moved == moved and moved > 0
        print(f"{tag}: KD on the true 1F1B schedule (pp={pp} x dp{n_devices // pp}, O(S) "
              f"stash, per-layer losses in-carry) |loss-ref|={derr2:.2e} "
              f"max|g-gpipe|={gerr:.2e} OK")
        del teacher, student

    # --- the head-sharded serving engine (tp) -------------------------------
    if n_devices >= 2:
        srv_cfg = dataclasses.replace(s_cfg, sea=dataclasses.replace(sea, use_cache=True))
        srv = OptForCausalLM(srv_cfg, device=device, seed=7)
        prompts = [[5, 9, 3], [7, 2, 11, 4]]

        def run_engine(model, group):
            eng = ServingEngine(model, max_slots=2, page_size=4, num_pages=32,
                                max_pages_per_slot=8, mesh=group, device=device)
            rids = [eng.submit(prompts[0], 5),
                    eng.submit(prompts[1], 5, temperature=1.0, top_k=1)]
            out = eng.run(chunk=3)
            return [out[r].output for r in rids]

        toks_plain = run_engine(srv, None)
        group = LocalGroup(2, device)
        toks_tp = run_engine(tensor_parallel(copy.deepcopy(srv), group), group)
        assert toks_tp == toks_plain, (toks_tp, toks_plain)
        print(f"{tag}: head-sharded serving engine (tp=2, paged KV pools over heads, mixed "
              f"sampling) tokens identical OK")
