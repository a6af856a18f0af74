"""The unified trainer CLI (PyTorch port of `sea_tpu/training/cli.py`, the
reference's `perlin_trainer.py` entry point).

One command dispatches on `--dataset` (wikitext2 -> the OPT/LLaMA KD
trainer, glue -> the GLUE trainer, lra -> the LRA trainer), derives the
experiment name from the SEA options with the reference's postfixes
(`format_exp`), and saves under `{save_root}/{experiment}`.

    python -m sea_tpu_torch.training.cli --dataset wikitext2 --model opt-125m \\
        --k 64 --predictor-length 256 --performer-nb-feature-factor 8
    python -m sea_tpu_torch.training.cli --dataset wikitext2 --model tiny --num-steps 4 \\
        --enable-lora --checkpoint-rotation 2 --supervised --device cpu

It runs on the card unless given `--device cpu`. The options and the
experiment names are JAX's, and `--log-steps` (the KD trainer's log and
heartbeat interval) the port's own. Unlike JAX's, whose KD trainer takes none of
them, the SEA knobs `--enable-lora`, `--attention-predictor-method`,
`--enc-per-layer`, `--k-oversample`, `--layerwise`, `--predictor-backend`,
`--context-output-method` and `--k-flatten-dim` reach the KD student's
config when they differ from their defaults (`TrainerConfig.
sea_overrides`); the GLUE and LRA trainers take none, so there they are
refused, as are `--supervised`, `--checkpoint-rotation`,
`--load-checkpoint`, `--teacher-checkpoint` and `--log-steps` (the KD
trainer's alone).
`--checkpoint-rotation n` keeps the n newest checkpoints behind a LATEST
pointer, `--supervised` runs `training.resilience.Supervisor` (resume the
newest intact checkpoint, roll back on divergence). `--data-parallel` splits
each batch over the processes of a `torch.distributed` world (the KD
trainer's `data_parallel`; refused for GLUE and LRA, as the other KD-trainer
options): launched by torchrun (WORLD_SIZE > 1), the CLI joins the world
itself, gloo on the CPU or NCCL with one card a process (LOCAL_RANK's):

    torchrun --nproc_per_node=2 -m sea_tpu_torch.training.cli --model tiny \
        --data-parallel --batch-size 2 --num-steps 4 --device cpu
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

# CLI option -> the SEA config field it sets on the KD student
SEA_KNOBS = {
    "enable_lora": "lora_enabled",
    "attention_predictor_method": "predictor_method",
    "enc_per_layer": "enc_per_layer",
    "k_oversample": "k_oversample",
    "layerwise": "layerwise",
    "predictor_backend": "predictor_backend",
    "context_output_method": "context_output_method",
    "k_flatten_dim": "k_flatten_dim",
}


def add_perlin_model_options(parser, predictor_length=128, k=7, nbf=1.0):
    """The shared SEA options (reference perlin_trainer.py:41-61)."""
    parser.add_argument("--method", default="perlin", type=str)
    parser.add_argument("--layerwise", action="store_true", default=False)
    parser.add_argument("--enable-lora", action="store_true", default=False)
    parser.add_argument("--k", default=k, type=int)
    parser.add_argument("--k-flatten-dim", default="causal_batch", type=str)
    parser.add_argument("--attention-predictor-method", default="mlp", type=str)
    parser.add_argument("--performer-nb-feature-factor", default=nbf, type=float)
    parser.add_argument("--token-merging", action="store_true", default=False)
    parser.add_argument("--token-merging-preserve", default=0.2, type=float)
    parser.add_argument("--token-merging-ratio", default=0.5, type=float)
    parser.add_argument("--predictor-length", default=predictor_length, type=int)
    parser.add_argument("--predictor-backend", type=str, default="performer")
    parser.add_argument("--enc-per-layer", action="store_true", default=False)
    parser.add_argument("--context-output-method", default="mix", type=str)
    parser.add_argument("--k-oversample", default=1.0, type=float)
    return parser


def format_exp(name: str, args) -> str:
    """The experiment name: `name` and a compact tag for each non-default
    knob, so that checkpoints never collide across configurations
    (reference perlin_trainer.py:200-224)."""
    b2i = lambda b: int(bool(b))  # noqa: E731
    postfixes = [
        f"lw{b2i(args.layerwise)}",
        f"{args.method}",
        f"k{args.k}" if args.k != 7 else "",
        "full" if not args.enable_lora else "",
        f"pred{args.attention_predictor_method}"
        if args.attention_predictor_method != "mlp" else "",
        f"nbf{args.performer_nb_feature_factor}"
        if args.performer_nb_feature_factor != 1 else "",
        f"tome_r{args.token_merging_ratio}_p{args.token_merging_preserve}"
        if args.token_merging else "",
        f"kdim_{args.k_flatten_dim}" if args.k_flatten_dim != "causal_batch" else "",
        f"pw{args.predictor_length}" if args.predictor_length != 256 else "",
        f"pbe{args.predictor_backend}" if args.predictor_backend != "performer" else "",
        "epl" if args.enc_per_layer else "",
        f"com_{args.context_output_method}" if args.context_output_method != "mix" else "",
        f"kover_{args.k_oversample}" if args.k_oversample != 1.0 else "",
    ]
    for p in postfixes:
        if p:
            name += f"_{p}"
    return name


def build_parser():
    parser = argparse.ArgumentParser(prog="sea_tpu_torch.training.cli")
    parser.add_argument("--dataset", default="wikitext2", choices=["wikitext2", "glue", "lra"])
    parser.add_argument("--model", default="opt-125m")
    parser.add_argument("--subset", default=None, type=str)
    parser.add_argument("--num-steps", default=None, type=int)
    parser.add_argument("--max-seq-len", default=None, type=int)
    parser.add_argument("--batch-size", default=None, type=int)
    parser.add_argument("--gradient-accumulation-steps", default=None, type=int)
    parser.add_argument("--eval-steps", default=None, type=int)
    # the port's own: the KD trainer's log (and heartbeat) interval
    parser.add_argument("--log-steps", default=None, type=int)
    parser.add_argument("--teacher-checkpoint", default=None, type=str)
    parser.add_argument("--load-checkpoint", default=None, type=str)
    parser.add_argument("--load-only-additionals", action="store_true")
    parser.add_argument("--eval", action="store_true", default=False)
    parser.add_argument("--save-root", default="./saves", type=str)
    parser.add_argument("--data-parallel", action="store_true", default=False)
    parser.add_argument("--scan-kd", action="store_true", default=False)
    parser.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16", "float32"])
    parser.add_argument("--param-dtype", default=None, choices=[None, "bfloat16", "float32"])
    parser.add_argument("--moment-dtype", default=None, choices=[None, "bfloat16", "float32"])
    parser.add_argument("--checkpoint-rotation", default=0, type=int)
    parser.add_argument("--supervised", action="store_true", default=False,
                        help="run under the in-process Supervisor (resume the newest "
                             "checkpoint, roll back on divergence)")
    parser.add_argument("--max-restarts", default=3, type=int)
    add_perlin_model_options(parser)
    parser.add_argument("--device", default="cuda",
                        help="the trainer's device ('cuda' unless 'cpu' is asked for)")
    return parser


def sea_overrides(args) -> dict:
    """The SEA knobs that differ from their defaults, as config fields."""
    parser = build_parser()
    return {field: getattr(args, opt) for opt, field in SEA_KNOBS.items()
            if getattr(args, opt) != parser.get_default(opt)}


def join_world(args) -> torch.device:
    """The device of this process. Under torchrun (WORLD_SIZE > 1) with
    `--data-parallel` and wikitext2, the process joins the torch.distributed
    world from torchrun's environment first (gloo on the CPU; NCCL on the
    card of its LOCAL_RANK)."""
    device = torch.device(args.device)
    if not (args.data_parallel and args.dataset == "wikitext2"
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def build_trainer(args):
    """(trainer, experiment name) of the parsed `args`."""
    device = join_world(args)
    if args.dataset == "wikitext2":
        from .opt_trainer import OptTrainer, TrainerConfig

        exp = format_exp(f"wikitext2_{args.model}", args)
        kw = dict(
            model=args.model,
            method=args.method,
            k=args.k,
            predictor_length=args.predictor_length,
            nb_factor=int(args.performer_nb_feature_factor),
            teacher_checkpoint=args.teacher_checkpoint,
            save_dir=os.path.join(args.save_root, exp),
            scan_kd=args.scan_kd,
            data_parallel=args.data_parallel,
            compute_dtype=args.compute_dtype,
            param_dtype=args.param_dtype,
            moment_dtype=args.moment_dtype,
            checkpoint_rotation=args.checkpoint_rotation,
            sea_overrides=sea_overrides(args) or None,
        )
        if args.num_steps is not None:
            kw["num_steps"] = args.num_steps
        if args.max_seq_len is not None:
            kw["max_seq_len"] = args.max_seq_len
            kw["stride"] = args.max_seq_len // 2
        if args.batch_size is not None:
            kw["batch_size"] = args.batch_size
        if args.gradient_accumulation_steps is not None:
            kw["gradient_accumulation_steps"] = args.gradient_accumulation_steps
        if args.eval_steps is not None:
            kw["eval_steps"] = args.eval_steps
        if args.log_steps is not None:
            kw["log_steps"] = args.log_steps
        return OptTrainer(TrainerConfig(**kw), device=device), exp
    refused = [f"--{opt.replace('_', '-')}" for opt in sea_overrides(args)]
    refused += [flag for flag, on in (
        ("--supervised", args.supervised),
        ("--checkpoint-rotation", args.checkpoint_rotation),
        ("--load-checkpoint", args.load_checkpoint),
        ("--teacher-checkpoint", args.teacher_checkpoint),
        ("--log-steps", args.log_steps),
        ("--data-parallel", args.data_parallel)) if on]
    if refused:
        raise SystemExit(f"{' and '.join(refused)} only supported with --dataset wikitext2 "
                         f"(got {args.dataset})")
    if args.dataset == "glue":
        from .glue_trainer import GlueTrainer, GlueTrainerConfig

        subset = args.subset or "mrpc"
        exp = format_exp(f"glue_{subset}", args)
        kw = dict(
            subset=subset,
            model=args.model if args.model != "opt-125m" else "bert-base",
            k=args.k,
            predictor_length=args.predictor_length,
            save_dir=os.path.join(args.save_root, exp),
        )
        if args.num_steps is not None:
            kw["num_steps"] = args.num_steps
        if args.batch_size is not None:
            kw["batch_size"] = args.batch_size
        if args.eval_steps is not None:
            kw["eval_steps"] = args.eval_steps
        if args.max_seq_len is not None:
            kw["max_length"] = args.max_seq_len
        return GlueTrainer(GlueTrainerConfig(**kw), device=device), exp
    from .lra_trainer import LraTrainer, LraTrainerConfig

    task = args.subset or "listops"
    exp = format_exp(f"lra_{task}", args)
    kw = dict(task=task, k=args.k, predictor_length=args.predictor_length,
              save_dir=os.path.join(args.save_root, exp))
    if args.num_steps is not None:
        kw["num_steps"] = args.num_steps
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.eval_steps is not None:
        kw["eval_steps"] = args.eval_steps
    if args.max_seq_len is not None:
        kw["max_length"] = args.max_seq_len
    return LraTrainer(LraTrainerConfig(**kw), device=device), exp


def main(argv=None):
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    trainer, exp = build_trainer(args)
    print(f"experiment: {exp}")
    if args.load_checkpoint:
        ok = trainer.load(args.load_checkpoint, only_additionals=args.load_only_additionals)
        print(f"loaded checkpoint {args.load_checkpoint}: {ok}")
    if args.eval:
        if args.dataset == "wikitext2":
            print("ppl:", trainer.evaluate(max_batches=32))
        elif args.dataset == "glue":
            print("score:", trainer.evaluate())
        else:
            print("acc:", trainer.evaluate("student"))
        return trainer
    if args.supervised:
        from .resilience import Supervisor

        report = Supervisor(trainer, max_restarts=args.max_restarts).run()
        print(f"supervised run complete: step={report.final_step} restarts={report.restarts}")
    else:
        trainer.train()
    if args.dataset == "wikitext2":
        # the LRA trainer saves as it trains; the GLUE trainer keeps no
        # checkpoint (JAX's CLI calls a save neither has)
        trainer.save()
    return trainer


if __name__ == "__main__":
    main()
