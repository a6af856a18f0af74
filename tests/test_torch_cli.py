"""The trainer CLI (sea_tpu_torch.training.cli vs sea_tpu.training.cli) and
the KD trainer's recovery (sea_tpu_torch.training.resilience), at the tiny
config on the CPU.

JAX's side is pure Python here (its parser and `format_exp`); the JAX
trainers are never built (their corpus loader would try a download). The
recovery checks are the port's own: rotation and the LATEST pointer, a torn
newest checkpoint renamed `.bad` and the older one resumed, a resumed run
equal to the uninterrupted one bit for bit, the Supervisor's rollback
after an injected non-finite loss, the heartbeat, and the refusals."""

import json
import os

import pytest
import torch

from sea_tpu.training import cli as jcli
from sea_tpu_torch.training import cli as tcli
from sea_tpu_torch.training import opt_trainer as to
from sea_tpu_torch.training import resilience as res


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGVS = [
    [],
    ["--dataset", "wikitext2", "--model", "opt-125m", "--enable-lora",
     "--checkpoint-rotation", "2", "--k", "64", "--predictor-length", "256",
     "--performer-nb-feature-factor", "8"],
    ["--dataset", "glue", "--subset", "cola", "--method", "performer", "--token-merging",
     "--k-flatten-dim", "batch", "--predictor-backend", "cosformer"],
    ["--dataset", "lra", "--attention-predictor-method", "comp", "--enc-per-layer",
     "--context-output-method", "norm", "--k-oversample", "2.0", "--layerwise",
     "--num-steps", "7", "--max-seq-len", "512", "--supervised", "--scan-kd",
     "--compute-dtype", "bfloat16", "--data-parallel"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "wikitext2_lora", "glue", "lra"])
def test_options_and_names_match_jax(argv):
    want = jcli.build_parser().parse_args(argv)
    got = tcli.build_parser().parse_args(argv)
    port_only = {"device", "log_steps"}
    assert {k: v for k, v in vars(got).items() if k not in port_only} == vars(want)
    for name in ("wikitext2_opt-125m", "glue_mrpc"):
        assert tcli.format_exp(name, got) == jcli.format_exp(name, want)


def tiny_cfg(tmp_path, **kw):
    base = dict(model="tiny", max_seq_len=64, stride=32, batch_size=2,
                gradient_accumulation_steps=2, num_steps=4, eval_steps=1000,
                log_steps=1, save_dir=str(tmp_path))
    base.update(kw)
    return to.TrainerConfig(**base)


def test_rotation_latest_and_heartbeat(tmp_path):
    tr = to.OptTrainer(tiny_cfg(tmp_path, checkpoint_rotation=2, eval_steps=1), device="cpu")
    tr.train()
    tags = res._step_tags(str(tmp_path))
    assert tags == ["ckpt_00000003", "ckpt_00000004"]
    assert res.resolve_latest(str(tmp_path)) == "ckpt_00000004"
    with open(tmp_path / "LATEST") as f:
        assert f.read() == "ckpt_00000004"
    with open(tmp_path / "heartbeat.json") as f:
        hb = json.load(f)
    assert hb["step"] == 4 and "loss" in hb
    age = res.heartbeat_age_s(str(tmp_path))
    assert age is not None and 0 <= age < 120
    assert res.heartbeat_age_s(str(tmp_path / "absent")) is None
    other = to.OptTrainer(tiny_cfg(tmp_path, checkpoint_rotation=2), device="cpu")
    assert other.load("latest") and other.step == 4
    for (n, a), b in zip(tr.student.state_dict().items(), other.student.state_dict().values()):
        assert torch.equal(a, b), n


def test_torn_newest_is_quarantined(tmp_path):
    tr = to.OptTrainer(tiny_cfg(tmp_path, checkpoint_rotation=3, eval_steps=1, num_steps=3),
                       device="cpu")
    tr.train()
    with open(tmp_path / "ckpt_00000003" / "state.pt", "wb") as f:
        f.write(b"torn")
    os.remove(tmp_path / "ckpt_00000002" / "state.pt")  # a directory without its file
    other = to.OptTrainer(tiny_cfg(tmp_path, checkpoint_rotation=3), device="cpu")
    assert res.resume_latest(other) == 1
    assert {"ckpt_00000001", "ckpt_00000002.bad", "ckpt_00000003.bad"} <= set(
        os.listdir(tmp_path))
    assert res._step_tags(str(tmp_path)) == ["ckpt_00000001"]
    with open(tmp_path / "ckpt_00000003.bad" / "state.pt", "rb") as f:
        assert f.read() == b"torn"  # renamed, never deleted


def test_resume_continues_bit_for_bit(tmp_path):
    """Two updates, a rotating save, a new trainer resumed from it, two
    more: the student and the optimizer equal the uninterrupted four
    updates' bit for bit."""
    full = to.OptTrainer(tiny_cfg(tmp_path / "full"), device="cpu")
    full.train()
    half = to.OptTrainer(tiny_cfg(tmp_path / "half", num_steps=2, checkpoint_rotation=2),
                         device="cpu")
    half.train()
    half.save()
    resumed = to.OptTrainer(tiny_cfg(tmp_path / "half", checkpoint_rotation=2), device="cpu")
    assert res.resume_latest(resumed) == 2
    resumed.train()
    assert resumed.step == full.step == 4
    for (n, a), b in zip(full.student.state_dict().items(),
                         resumed.student.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for key in sa:
        for name in sa[key]:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)


def test_supervisor_rolls_back_after_nan(tmp_path, monkeypatch):
    """A non-finite loss injected at update 3 (after the checkpoint of
    update 2): `TrainingDiverged` at the log boundary, the rollback to
    update 2, the data stream moved past the window, and the run completed."""
    tr = to.OptTrainer(tiny_cfg(tmp_path, checkpoint_rotation=2, eval_steps=2, num_steps=4),
                       device="cpu")
    real = tr.micro_step
    calls = {"n": 0}

    def poisoned(ids, mask, labels):
        out = real(ids, mask, labels)
        calls["n"] += 1
        if calls["n"] == 6:  # the last micro-step of update 3, which it logs
            out = {**out, "loss": torch.tensor(float("nan"))}
        return out

    monkeypatch.setattr(tr, "micro_step", poisoned)
    report = res.Supervisor(tr, max_restarts=2).run()
    assert report.completed and report.final_step == 4 and report.restarts == 1
    assert "TrainingDiverged" in report.events[0]
    assert tr.data_offset == 2  # one update's micro-batches
    assert all(torch.isfinite(p).all() for p in tr.student.parameters())


def test_supervisor_gives_up(tmp_path, monkeypatch):
    tr = to.OptTrainer(tiny_cfg(tmp_path, num_steps=2), device="cpu")
    monkeypatch.setattr(tr, "micro_step", lambda *a: {"loss": torch.tensor(float("inf"))})
    with pytest.raises(res.TrainingDiverged):
        res.Supervisor(tr, max_restarts=1).run()
    assert to.TrainingDiverged is res.TrainingDiverged


def test_main_in_process_with_lora_and_rotation(tmp_path, capsys):
    """`main` on the tiny model: --enable-lora reaches the student (its
    deltas trained in the high-lr group), two rotating checkpoints, the
    supervised run, then --eval from the saved state."""
    argv = ["--dataset", "wikitext2", "--model", "tiny", "--enable-lora", "--num-steps", "3",
            "--max-seq-len", "64", "--gradient-accumulation-steps", "1", "--eval-steps", "1",
            "--log-steps", "1", "--checkpoint-rotation", "2", "--supervised",
            "--save-root", str(tmp_path), "--device", "cpu"]
    tr = tcli.main(argv)
    exp = "wikitext2_tiny_lw0_perlin_pw128"
    assert f"experiment: {exp}" in capsys.readouterr().out
    assert tr.s_cfg.sea.lora_enabled and tr.cfg.sea_overrides == {"lora_enabled": True}
    assert any(n.endswith("perlin_q_lora.lora_b") and p.abs().max() > 0
               for n, p in tr.student.named_parameters())
    save_dir = str(tmp_path / exp)
    assert res._step_tags(save_dir) == ["ckpt_00000002", "ckpt_00000003"]
    assert res.heartbeat_age_s(save_dir) < 120
    ev = tcli.main(["--model", "tiny", "--enable-lora", "--max-seq-len", "64",
                    "--save-root", str(tmp_path), "--device", "cpu",
                    "--load-checkpoint", "latest", "--eval"])
    assert ev.step == 3 and "ppl:" in capsys.readouterr().out


def test_refusals(tmp_path):
    """The KD trainer's options stay refused for GLUE and LRA; wikitext2
    takes `--data-parallel` (queue 1 item 8.1; in one process a trainer
    without a group)."""
    args = tcli.build_parser().parse_args(["--model", "tiny", "--data-parallel", "--device",
                                           "cpu", "--save-root", str(tmp_path)])
    tr, _ = tcli.build_trainer(args)
    assert tr.cfg.data_parallel and tr.dp is None
    for argv in (["--dataset", "glue", "--enable-lora"],
                 ["--dataset", "lra", "--checkpoint-rotation", "2"],
                 ["--dataset", "glue", "--supervised"],
                 ["--dataset", "lra", "--data-parallel"]):
        with pytest.raises(SystemExit, match="only supported with --dataset wikitext2"):
            tcli.main(argv + ["--device", "cpu"])
