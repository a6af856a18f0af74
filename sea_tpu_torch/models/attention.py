"""SEA attention core (PyTorch port): estimator -> top-k mask -> sparse attention.

Port of the fused paths of `sea_tpu/models/attention.py` (`SeaAttention`),
stage for stage, with the same profiler region and buffer names:

  1 "vmask"           identity-value construction, v_for_atten = [id ‖ v]
  2 "performer"       FAVOR+ linear attention over (q, k, v_for_atten), fp32
                      (or the cosformer backend, `predictor_backend="cosformer"`)
  3 "performer_value" concat [performer_ctx ‖ v]
  4 "predictor"       enc MLP -> dec_row + ChannelSplit -> CNN -> score
  5 "mask_softmax"    softmax of the estimate
  6 "mask"            grouped top-k over (N, T_DST, H·T_M) with per-row budget
  7-8 "attention.fused"  the fused sparse kernel
  9 "attention.avg_pool" mix with the average context, per-query gate

The module is causal (OPT) or non-causal (BERT), as `cfg.causal` says:

  * causal: learned identity values, ReLU-feature causal performer, the
    dilated causal CNN, a per-row budget, kernel K1 (or K2-K4 in training),
    and the running average of v;
  * non-causal: tent identity rows at each token's relative position,
    softmax-feature performer, the strided CNN (no LayerNorm), one budget per
    example, kernel K5 on q / sqrt(D) with each example's token count as its
    row width (right padding), and the average of v weighted by the
    estimate's mean row, resized to T (`resize_noncausal`). It takes the
    (N, 1, 1, T) additive padding mask and runs the benchmark path only.

Two paths run stage 7-8:

  * the benchmark path (`benchmarking=True`): the forward kernel
    (`sea_block_sparse_attention`) on the binary top-k mask;
  * task-only training (`benchmarking=False` with `cfg.use_fused_train`, no
    KD truths, `k_oversample == 1`): the differentiable fused kernel
    (`fused_sparse_attention`) on the additive train-mode mask. Gradients
    reach the estimator only through the gate head (`dec_scaler`) and the
    average-context mix; `dec_row` and the CNN get none, because top-k is a
    selection. This path also takes the thin (N, 1, T, 1) causal mask that
    `OptModel.embed` builds for it.

Inside `parallel.context.sharded_attention_scope(group, kind=...)` both
causal paths run sharded over the shard group, by the kind that
`resolve_attention_kind` picks: 'ring' (K/V sequence-sharded and rotating
around the group, kernels K6 forward and K7/K8 backward; blocks
`block_q or 128`), 'head' or 'seq' (K1, or K2-K4 in training, on each
shard's heads or rows; the JAX package's `auto_block` sizes in training).
Without a scope nothing changes.

Not ported yet, and refused with NotImplementedError rather than routed
elsewhere: the dense differentiable train path and its KD losses
(`benchmarking=False` without `use_fused_train`, and every train path of
the non-causal module), the non-causal oversampled benchmark path (a CSR
route in JAX), the uniform-CSR path (`use_pallas=False`), the 'comp'
predictor, `enc_per_layer`, LoRA, and the decode cache.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SeaConfig
from ..ops.kernels.block_sparse import fused_sparse_attention, sea_block_sparse_attention
from ..ops.cosformer import CosformerAttention
from ..ops.masks import fp_min_for, per_item_top_k, resize_noncausal, topk_mask
from ..ops.performer import fast_attention, gaussian_orthogonal_random_matrix
from ..parallel import sharded_attention as sharded
from ..parallel.context import current_attention_sharding, resolve_attention_kind
from ..utils.profiler import get_bench
from .modules import CausalConv2d, ChannelSplit, KeepRes, interpolate, upsample_nearest


class SeaAttentionOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    context_layer: torch.Tensor
    partial_attention_probs: Any
    partial_attention_mask: Any
    estimated_attention_probs_m: torch.Tensor
    estimated_attention_probs: Optional[torch.Tensor]
    dense_attention_probs: Optional[torch.Tensor]
    key_for_score: torch.Tensor
    state: Any


def auto_block(t: int) -> int:
    """The JAX package's block size of the differentiable path: the largest
    of 512, 256 and 128 that divides T."""
    for b in (512, 256, 128):
        if t % b == 0:
            return b
    raise ValueError(f"use_fused_train needs a multiple of 128 tokens, got {t}")


def softmax_fp32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax in float32, cast back to the input dtype."""
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


def _layer_norm(features: int) -> nn.LayerNorm:
    # flax's LayerNorm epsilon, not torch's 1e-5
    return nn.LayerNorm(features, eps=1e-6)


def init_random_(root: nn.Module, generator: torch.Generator):
    """Seeded random init of every parameter and buffer under `root`, drawn
    on the CPU from `generator` (so a seed gives the same weights on every
    device): linears N(0, 1/fan_in) with zero bias, embeddings
    N(0, 1/features), LayerNorms the identity, causal convs U(±1/sqrt(fan_in)),
    each SEA module's FAVOR+ projection and identity-value table."""

    def randn(shape):
        return torch.randn(shape, generator=generator)

    with torch.no_grad():
        for m in root.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(randn(m.weight.shape) * m.weight.shape[1] ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(randn(m.weight.shape) * m.weight.shape[1] ** -0.5)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, CausalConv2d):
                m.reset_parameters(generator)
            elif isinstance(m, SeaAttention):
                m.performer_proj.copy_(gaussian_orthogonal_random_matrix(
                    generator, m.cfg.nb_features, m.cfg.head_dim, device="cpu"
                ))
                if m.cfg.causal:
                    m.v_eye_learned_causal.copy_(randn(m.v_eye_learned_causal.shape))


class SeaAttention(nn.Module):
    """The SEA attention module, one per transformer layer. Built on
    `device` with seeded random weights (`seed=None` leaves them
    uninitialised, for `load_state_dict` or a parent's init). Only the
    modules the JAX package builds for `cfg` exist, so that its variable
    trees map one to one."""

    def __init__(self, cfg: SeaConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if not cfg.causal and cfg.k_oversample != 1.0:
            raise NotImplementedError(
                "the non-causal oversampled benchmark path (uniform CSR) is not ported"
            )
        if cfg.predictor_method != "mlp":
            raise NotImplementedError("only predictor_method='mlp' is ported")
        if cfg.enc_per_layer or cfg.lora_enabled or cfg.lora_in_approx_enabled:
            raise NotImplementedError("enc_per_layer and LoRA are not ported yet")
        self.cfg = cfg
        D, H, T_M = cfg.head_dim, cfg.num_heads, cfg.predictor_length

        # FAVOR+ projection: a buffer, not a parameter (redrawn, never trained)
        self.register_buffer(
            "performer_proj",
            torch.empty(cfg.nb_features, D),
        )
        if cfg.predictor_backend == "cosformer":
            # the cosformer estimator backend (reference attention.py:169-178):
            # CosformerAttention(embed_dim, vdim=2·embed_dim, no out-projection)
            self.cosformer_backend = CosformerAttention(
                H * D, H, vdim=2 * H * D, has_outproj=False, causal=cfg.causal,
                device="cpu",
            )
        if cfg.context_output_method == "norm":
            self.norm_partial = _layer_norm(H * D)
        if cfg.out_norm:
            self.out_norm_ln = _layer_norm(H * D)

        # predictor encoder: Linear(3D -> 2D) + LN + GELU
        self.enc_dense = nn.Linear(3 * D, 2 * D)
        self.enc_ln = _layer_norm(2 * D)
        # decoder row projector + channel split
        splits = cfg.splits
        down = cfg.dec_row_down_scale
        self.dec_row = nn.Linear(2 * D, (T_M // down) * splits)
        self.channel_split = ChannelSplit(splits)
        ch = splits * H
        if cfg.causal:
            # LN -> 2x dilated causal conv -> up(1,4) -> 1x1 conv (padding 1
            # widens T_M to T_M+2) -> area resize back to T_M -> LN
            self.cnn_ln1 = _layer_norm(T_M // down)
            self.cnn_conv1 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
            self.cnn_conv2 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
            if cfg.cnn_deeper:
                self.cnn_conv3 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
            self.cnn_conv4 = CausalConv2d(ch, H, 1, padding=1, causal=True)
            self.cnn_ln2 = _layer_norm(T_M)
        else:
            # strided conv (2, 1) -> conv -> nearest up (2, 1) -> conv, then
            # a resize to (T, T_M) (linear widening of T_M/2)
            self.cnn_conv1 = CausalConv2d(ch, 4 * H, 3, padding=1, stride=(2, 1))
            self.cnn_conv2 = CausalConv2d(4 * H, 4 * H, 3, padding=1)
            self.cnn_conv3 = CausalConv2d(4 * H, H, 3, padding=1)
        # per-query two-channel gate head
        self.dec_scaler = nn.Linear(2 * D, 2)
        if cfg.causal:
            # learned identity-value embeddings
            self.v_eye_learned_causal = nn.Parameter(
                torch.empty(1, 1, cfg.max_position_embeddings, D)
            )
        if seed is not None:
            init_random_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    # ------------------------------------------------------------------
    def _context_output(self, pcl: torch.Tensor) -> torch.Tensor:
        """Stage 9 output method on the merged (N, T, H·D) context: 'mix' is
        the identity; 'norm' adds a LayerNorm residual; out_norm applies a
        final LayerNorm."""
        if self.cfg.context_output_method == "norm":
            pcl = self.norm_partial(pcl) + pcl
        if self.cfg.out_norm:
            pcl = self.out_norm_ln(pcl)
        return pcl

    def _identity_values(self, v_for_atten: torch.Tensor, zero_one_mask: torch.Tensor,
                         t_src: int) -> torch.Tensor:
        """Stage 1 "vmask". Causal: a slice of the learned positional table.
        Non-causal: identity rows sampled bilinearly at each token's
        relative position among the kept tokens (zero_one_mask (N, 1, 1, T)),
        a tent max(0, 1 − |pos·(D−1) − j|) over the D channels."""
        N, H, T, D = v_for_atten.shape
        if self.cfg.causal:
            v_id = self.v_eye_learned_causal[:, :, :t_src, :].to(v_for_atten.dtype)
            return v_id.expand(N, H, t_src, D)
        cs = torch.cumsum(zero_one_mask, dim=-1)
        L = zero_one_mask.sum(-1, keepdim=True)
        pos01 = (cs - 1.0) / (L - 1.0 + 1e-8)  # tensor / tensor: a true division
        r = pos01.reshape(N, 1, T, 1) * (D - 1)
        j = torch.arange(D, dtype=torch.float32, device=r.device).reshape(1, 1, 1, D)
        tent = torch.clamp(1.0 - torch.abs(r - j), min=0.0)
        return tent.expand(N, H, T, D).to(v_for_atten.dtype)

    def _predictor_cnn(self, x: torch.Tensor) -> torch.Tensor:
        """Stage 4 CNN. x: (N, C, T, T_M/down) -> (N, H, T, T_M)."""
        cfg = self.cfg
        T_M = cfg.predictor_length
        if not cfg.causal:
            # an odd T comes back with T + 1 rows: the resize shrinks them
            return KeepRes(
                (self.cnn_conv1, torch.relu, self.cnn_conv2, torch.relu,
                 lambda y: upsample_nearest(y, (2, 1)), self.cnn_conv3),
                output_width=T_M,
            )(x)

        def stack(y):
            y = self.cnn_ln1(y)
            h_in = y.shape[-2]
            y = torch.relu(self.cnn_conv1(y))
            y = torch.relu(self.cnn_conv2(y))
            if cfg.cnn_deeper:
                y = torch.relu(self.cnn_conv3(y))
            y = upsample_nearest(y, (1, 4))
            y = self.cnn_conv4(y)
            y = interpolate(y, (h_in, T_M))
            return self.cnn_ln2(y)

        T = x.shape[-2]
        C = cfg.cnn_row_chunk
        if C and T > C and T % C == 0:
            # overlap-discard chunking over the query rows: only the causal
            # convs look back, 4 rows each, so a halo of 4 rows per conv
            # makes each chunk's kept rows exact
            halo = 4 * (3 if cfg.cnn_deeper else 2)
            outs = []
            for i in range(T // C):
                s0 = i * C
                lo = max(0, s0 - halo)
                outs.append(stack(x[:, :, lo : s0 + C, :])[:, :, s0 - lo :, :])
            return torch.cat(outs, dim=-2)
        return stack(x)

    # ------------------------------------------------------------------
    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        q_for_atten: torch.Tensor,
        k_for_atten: torch.Tensor,
        v_for_atten: torch.Tensor,
        q_for_score: torch.Tensor,
        k_for_score: torch.Tensor,
        attention_mask: torch.Tensor,
        attention_scores_truth: Optional[torch.Tensor] = None,
        context_layer_truth: Optional[torch.Tensor] = None,
        *,
        benchmarking: bool = False,
        training: bool = False,
    ) -> SeaAttentionOutput:
        cfg = self.cfg
        truths = (
            attention_scores_truth is not None
            or context_layer_truth is not None
            or (cfg.kd_self_teacher and training)
        )
        # task-only training through the differentiable fused kernel
        use_fused_train = (
            not benchmarking
            and cfg.causal
            and cfg.use_fused_train
            and cfg.use_pallas
            and not truths
            and cfg.k_oversample == 1.0
        )
        if not (benchmarking or use_fused_train):
            raise NotImplementedError(
                "the dense train path (benchmarking=False without "
                "use_fused_train) is not ported yet"
            )
        if not cfg.use_pallas:
            raise NotImplementedError("the uniform-CSR path is not ported")
        bench = get_bench()
        N, H, T, D = q.shape
        assert H == cfg.num_heads and D == cfg.head_dim, (
            f"input geometry ({H} heads, d={D}) does not match SeaConfig "
            f"({cfg.num_heads} heads, d={cfg.head_dim})"
        )
        T_M = cfg.predictor_length
        FP_MIN = fp_min_for(q.dtype)

        # --- mask plumbing: causal, the (N, 1, T, T) additive mask or its thin
        # (N, 1, T, 1) dst column, of which every consumer below reads only
        # the dst and src padding slices (the kernels derive causality
        # themselves); non-causal, the (N, 1, 1, T) padding mask -------------
        if not cfg.causal:
            T_DST = T_SRC = attention_mask.shape[-1]
            dst_attention_mask = attention_mask.transpose(-1, -2)
        elif attention_mask.shape[-1] == 1:
            if not cfg.use_fused_train or truths or cfg.kd_self_teacher:
                raise ValueError(
                    "the thin causal mask requires the fused-train path (no KD loss)"
                )
            T_DST = T_SRC = attention_mask.shape[-2]
            dst_attention_mask = attention_mask
            attention_mask = attention_mask.transpose(-1, -2)
        else:
            T_DST, T_SRC = attention_mask.shape[-2:]
            dst_attention_mask = attention_mask[:, :, :, :1]
            attention_mask = dst_attention_mask.transpose(-1, -2)
        zero_one_attention_mask = (attention_mask > -1).float()
        dst_alive = dst_attention_mask > -1  # (N, 1, T_DST, 1)

        bench.register_temp_buffer("q", q)
        bench.register_temp_buffer("k", k)
        bench.register_temp_buffer("v", v)

        # --- 1 "vmask" ----------------------------------------------------
        with bench.region("vmask"):
            v_id = self._identity_values(v_for_atten, zero_one_attention_mask, T_SRC)
            v_for_atten = torch.cat([v_id, v_for_atten], dim=-1)
            v_for_atten = torch.where(dst_alive, v_for_atten, torch.zeros_like(v_for_atten))
            v = torch.where(dst_alive, v, torch.zeros_like(v))
            bench.register_temp_buffer("v_for_atten", v_for_atten)

        # --- 2 "performer" (float32) ---------------------------------------
        with bench.region("performer"):
            if cfg.predictor_backend == "cosformer":
                # the sequence-first layout: (N, H, T, d) -> (T, N, H·d)
                D2 = v_for_atten.shape[-1]

                def to_seq(x, d):
                    return x.permute(0, 2, 1, 3).reshape(N, -1, H * d).transpose(0, 1).float()

                t_out = self.cosformer_backend(
                    to_seq(q_for_atten, D), to_seq(k_for_atten, D), to_seq(v_for_atten, D2)
                )  # (T, N, H·2D)
                performer_context_layer = t_out.reshape(-1, N, H, D2).permute(
                    1, 2, 0, 3).to(q_for_atten.dtype)
            else:
                performer_context_layer = fast_attention(
                    q_for_atten.float(),
                    k_for_atten.float(),
                    v_for_atten.float(),
                    self.performer_proj,
                    causal=cfg.causal,
                    generalized=cfg.causal,
                ).to(q_for_atten.dtype)
            bench.register_temp_buffer("performer_context_layer", performer_context_layer)

        # --- 3 "performer_value" -------------------------------------------
        with bench.region("performer_value"):
            performer_value = torch.cat([performer_context_layer, v], dim=-1)
            bench.register_temp_buffer("performer_value", performer_value)

        # --- 4 "predictor" -------------------------------------------------
        with bench.region("predictor"):
            s = cfg.query_skips
            t_enc_x = performer_value
            if s > 1:
                assert T_DST % s == 0
                t_enc_x = t_enc_x[:, :, ::s, :]
            t_attention_predictor = F.gelu(
                self.enc_ln(self.enc_dense(t_enc_x)), approximate="none"
            )
            estimated_attention_score = self.dec_row(t_attention_predictor)
            # (N, H, T', out_ch) read as NCHW -> ChannelSplit -> CNN
            estimated_attention_score = self.channel_split(estimated_attention_score)
            estimated_attention_score = self._predictor_cnn(estimated_attention_score)
            if s > 1:
                estimated_attention_score = torch.repeat_interleave(
                    estimated_attention_score, s, dim=2
                )
                t_attention_predictor = torch.repeat_interleave(
                    t_attention_predictor, s, dim=2
                )
            bench.register_temp_buffer("t_attention_predictor", t_attention_predictor)

        # --- 5 "mask_softmax" ----------------------------------------------
        with bench.region("mask_softmax"):
            estimated_attention_probs = softmax_fp32(estimated_attention_score, -1)
        bench.register_temp_buffer("estimated_attention_score", estimated_attention_score)
        bench.register_temp_buffer("estimated_attention_probs", estimated_attention_probs)

        # --- 6 "mask": grouped top-k ----------------------------------------
        with bench.region("mask"):
            masked_estimated_attention_probs = (
                estimated_attention_probs * dst_alive.to(estimated_attention_probs.dtype)
            )
            bench.register_temp_buffer(
                "masked_estimated_attention_probs", masked_estimated_attention_probs
            )
            token_length = zero_one_attention_mask.sum(-1).reshape(N, -1)
            causal_token_length = torch.arange(
                1, T_DST + 1, dtype=torch.float32, device=q.device
            ).reshape(1, T_DST, 1).expand(N, T_DST, 1) if cfg.causal else None
            budget = per_item_top_k(
                cfg_k=cfg.effective_k,
                k_oversample=cfg.k_oversample,
                k_flatten_dim=cfg.k_flatten_dim,
                num_heads=H,
                t_m=T_M,
                token_length=token_length,
                causal_token_length=causal_token_length,
                causal=cfg.causal,
            )
            bench.register_temp_buffer("per_item_top_k", budget)
            # binary {0, 1} on the benchmark path, additive {0, FP_MIN} in train
            partial_attention_mask_m = topk_mask(
                masked_estimated_attention_probs,
                dst_alive,
                budget,
                cfg.k_flatten_dim,
                benchmarking,
                FP_MIN,
            )
        bench.register_temp_buffer(
            "partial_attention_mask_before_interp", partial_attention_mask_m
        )

        # --- 7-8 the fused kernel: mask expansion, tile-skipped masked
        # softmax, P·V and the row scaler in one launch ----------------------
        with bench.region("attention.fused"):
            estimated_scales = self.dec_scaler(t_attention_predictor)
            bench.register_temp_buffer("estimated_scales", estimated_scales)
            row_scaler = (
                torch.sigmoid(estimated_scales[..., 0])
                if cfg.partial_attention_scaler
                else None
            )
            shard_ctx = current_attention_sharding() if cfg.causal else None
            kind = None if shard_ctx is None else resolve_attention_kind(
                shard_ctx, t=T_SRC, oversample=cfg.k_oversample)
            if benchmarking:
                mask_bin = (partial_attention_mask_m > 0).to(q.dtype)
                if cfg.causal:
                    q_kern, lengths = q_for_score, None
                else:
                    # the BERT path scales the scores by 1/sqrt(D); for D = 64
                    # (and 16) the reciprocal a CUDA division takes is exact
                    q_kern = q_for_score / math.sqrt(D)
                    lengths = zero_one_attention_mask[:, 0, 0, :].sum(-1).to(torch.int32)
                    bench.register_temp_buffer("lengths", lengths)
                kernel_kw = dict(oversample=cfg.k_oversample, k_cfg=float(cfg.effective_k))
                if kind == "head":
                    partial_context_layer = sharded.head_sharded_sea_attention(
                        q_kern, k_for_score, v, mask_bin, row_scaler, shard_ctx.group,
                        block_q=shard_ctx.block_q, block_k=shard_ctx.block_k, **kernel_kw,
                    )
                elif kind == "ring":
                    assert cfg.k_oversample == 1.0, (
                        "ring sharding does not implement the oversample "
                        "keep-predicate; use kind='seq'"
                    )
                    partial_context_layer = sharded.ring_sea_attention(
                        q_kern, k_for_score, v, mask_bin, row_scaler, shard_ctx.group,
                        zigzag=shard_ctx.zigzag, block_q=shard_ctx.block_q or 128,
                        block_k=shard_ctx.block_k or 128,
                    )
                elif kind == "seq":
                    partial_context_layer = sharded.sharded_sea_attention(
                        q_kern, k_for_score, v, mask_bin, row_scaler, shard_ctx.group,
                        zigzag=shard_ctx.zigzag, block_q=shard_ctx.block_q,
                        block_k=shard_ctx.block_k, **kernel_kw,
                    )
                else:
                    partial_context_layer = sea_block_sparse_attention(
                        q_kern,
                        k_for_score,
                        v,
                        mask_bin,
                        row_scaler,
                        is_causal=cfg.causal,
                        lengths=lengths,
                        block_q=cfg.block_q,
                        oversample=cfg.k_oversample if cfg.causal else 1.0,
                        k_cfg=float(cfg.effective_k),
                    )
            else:
                mask_bin = (partial_attention_mask_m > -1.0).to(q.dtype)
                if row_scaler is None:
                    row_scaler = torch.ones((N, H, T_DST), dtype=q.dtype, device=q.device)
                if kind == "ring":
                    partial_context_layer = sharded.ring_fused_train_attention(
                        q_for_score, k_for_score, v, mask_bin, row_scaler, shard_ctx.group,
                        shard_ctx.zigzag, shard_ctx.block_q or 128, shard_ctx.block_k or 128,
                    )
                elif kind in ("head", "seq"):
                    blocks = dict(block_q=shard_ctx.block_q or cfg.block_q or auto_block(T_DST),
                                  block_k=shard_ctx.block_k or auto_block(T_SRC))
                    if kind == "head":
                        partial_context_layer = sharded.head_sharded_fused_train(
                            q_for_score, k_for_score, v, mask_bin, row_scaler,
                            shard_ctx.group, **blocks,
                        )
                    else:
                        partial_context_layer = sharded.sharded_fused_train_attention(
                            q_for_score, k_for_score, v, mask_bin, row_scaler,
                            shard_ctx.group, zigzag=shard_ctx.zigzag, **blocks,
                        )
                else:
                    partial_context_layer = fused_sparse_attention(
                        q_for_score, k_for_score, v, mask_bin, row_scaler,
                        block_q=cfg.block_q,
                    )
            # the kernel's output, whose gradient is the backward kernels' dO
            bench.register_temp_buffer("fused_attention_output", partial_context_layer)
        with bench.region("attention.avg_pool"):
            if cfg.causal:
                avg_v = v * dst_alive.to(v.dtype)
                denom = torch.arange(
                    1, T_SRC + 1, dtype=torch.float32, device=v.device
                ).reshape(1, 1, -1, 1)
                average_context_layer = (
                    torch.cumsum(avg_v.float(), dim=-2) / denom
                ).to(v.dtype)
            else:
                # the estimate's mean over every row, padded rows included
                # (as in the JAX package), resized to T columns: one weight
                # per key, zero at padding
                mean_probs = estimated_attention_probs.mean(-2, keepdim=True)
                w = resize_noncausal(
                    mean_probs, 0.0, attention_mask=attention_mask, target_width=T_SRC,
                ).transpose(-1, -2)
                average_context_layer = (
                    v * dst_alive.to(v.dtype) * w.to(v.dtype)
                ).sum(-2, keepdim=True)
            average_scale = torch.sigmoid(estimated_scales[..., 1:2])
            partial_context_layer = (
                partial_context_layer * average_scale
                + (1 - average_scale) * average_context_layer
            )
        partial_context_layer = partial_context_layer.permute(0, 2, 1, 3).reshape(
            N, T_DST, H * D
        )
        partial_context_layer = self._context_output(partial_context_layer)
        bench.register_temp_buffer("partial_context_layer", partial_context_layer)
        return SeaAttentionOutput(
            loss=torch.zeros((), dtype=torch.float32, device=q.device),
            context_layer=partial_context_layer,
            partial_attention_probs=None,
            partial_attention_mask=partial_attention_mask_m,
            estimated_attention_probs_m=estimated_attention_probs,
            estimated_attention_probs=estimated_attention_probs,
            dense_attention_probs=None,
            key_for_score=k_for_score,
            state=None,
        )
