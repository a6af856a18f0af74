"""SEA attention core (PyTorch port): estimator -> top-k mask -> sparse attention.

Port of `sea_tpu/models/attention.py` (`SeaAttention`), stage for stage,
with the same profiler region and buffer names:

  1 "vmask"           identity-value construction, v_for_atten = [id ‖ v]
  2 "performer"       FAVOR+ linear attention over (q, k, v_for_atten), fp32
                      (or the cosformer backend, `predictor_backend="cosformer"`)
  3 "performer_value" concat [performer_ctx ‖ v]
  4 "predictor"       enc MLP -> dec_row + ChannelSplit -> CNN -> score
  5 "mask_softmax"    softmax of the estimate (and the estimator's KD loss)
  6 "mask"            grouped top-k over (N, T_DST, H·T_M) with per-row budget
  7-8 "attention.fused"  the fused sparse kernel, or on the dense train path
      "interp", "attention"  the resized mask and dense masked attention
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

Three paths run stages 7-8:

  * the benchmark path (`benchmarking=True`): the forward kernel
    (`sea_block_sparse_attention`) on the binary top-k mask;
  * task-only training (`benchmarking=False` with `cfg.use_fused_train`, no
    KD truths, `k_oversample == 1`): the differentiable fused kernel
    (`fused_sparse_attention`) on the additive train-mode mask. Gradients
    reach the estimator only through the gate head (`dec_scaler`) and the
    average-context mix; `dec_row` and the CNN get none, because top-k is a
    selection. This path also takes the thin (N, 1, T, 1) causal mask that
    `OptModel.embed` builds for it;
  * the dense train path (`benchmarking=False` otherwise), plain PyTorch as
    in the JAX module: the compressed mask resized to (T, T) ("interp"),
    dense scores, the masked softmax with dead entries zeroed, the row
    scaler and P·V ("attention"). With the teacher's truths it adds the KD
    losses: the estimate's resized scores and the dense scores each against
    the teacher's scores (0.1 · KL plus the softmaxes' squared error), and
    the context layer's squared error; it returns the resized estimate. In
    training the causal resizes take the jitter's draws (`jitter=`). It is
    the train path of KD and the reference the fused kernels are held to.

Inside `parallel.context.sharded_attention_scope(group, kind=...)` both
causal fused paths run sharded over the shard group, by the kind that
`resolve_attention_kind` picks: 'ring' (K/V sequence-sharded and rotating
around the group, kernels K6 forward and K7/K8 backward; blocks
`block_q or 128`), 'head' or 'seq' (K1, or K2-K4 in training, on each
shard's heads or rows; the JAX package's `auto_block` sizes in training).
Without a scope nothing changes; the dense path is never sharded.

Not ported yet, and refused with NotImplementedError rather than routed
elsewhere: `kd_self_teacher`, the non-causal oversampled benchmark path (a
CSR route in JAX), the uniform-CSR benchmark path (`use_pallas=False`), the
'comp' predictor, `enc_per_layer`, LoRA, and the decode cache.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SeaConfig
from ..ops.kernels.block_sparse import fused_sparse_attention, sea_block_sparse_attention
from ..ops.cosformer import CosformerAttention
from ..ops.masks import (
    fp_min_for,
    per_item_top_k,
    resize_index,
    resize_with_index,
    topk_mask,
)
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


def _kl_div_attention(log_input, target, attention_mask):
    """Padding-masked attention KL: summed over the kept (row, column) pairs
    of the (N, 1, 1, T) additive mask, divided by the kept rows."""
    loss_pointwise = target * (torch.log(target + 1e-12) - log_input)
    one_mask = (attention_mask > -1).float()
    mask = one_mask * one_mask.transpose(-1, -2)
    return (loss_pointwise * mask).sum() / (one_mask[:, :, 0, :].sum() + 1e-8)


def _kl_div_batchmean(log_input, target):
    """`F.kl_div(reduction='batchmean')` over the rows of (N, H, T, T)."""
    rows = log_input.shape[0] * log_input.shape[1] * log_input.shape[2]
    return (target * (torch.log(target + 1e-12) - log_input)).sum() / rows


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
        jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> SeaAttentionOutput:
        """jitter: the resize jitter's draws (`ops.masks.resize_jitter_draws`
        of the (N, 1, T, T) mask's shape), read only on the dense path when
        `training` and causal; None draws nothing, as the JAX module does
        without an `rng`."""
        cfg = self.cfg
        if cfg.kd_self_teacher and training and attention_scores_truth is None:
            raise NotImplementedError(
                "kd_self_teacher is not ported yet (ROADMAP queue 1, "
                "'KD and trainer leftovers')"
            )
        truths = attention_scores_truth is not None or context_layer_truth is not None
        # task-only training through the differentiable fused kernel
        use_fused_train = (
            not benchmarking
            and cfg.causal
            and cfg.use_fused_train
            and cfg.use_pallas
            and not truths
            and cfg.k_oversample == 1.0
        )
        if benchmarking and not cfg.use_pallas:
            raise NotImplementedError("the uniform-CSR path is not ported")
        bench = get_bench()
        N, H, T, D = q.shape
        assert H == cfg.num_heads and D == cfg.head_dim, (
            f"input geometry ({H} heads, d={D}) does not match SeaConfig "
            f"({cfg.num_heads} heads, d={cfg.head_dim})"
        )
        T_M = cfg.predictor_length
        FP_MIN = fp_min_for(q.dtype)

        # --- mask plumbing: causal, the (N, 1, T, T) additive mask (kept as
        # causal_attention_mask for the dense path) or its thin (N, 1, T, 1)
        # dst column, of which the fused paths read only the dst and src
        # padding slices (the kernels derive causality themselves);
        # non-causal, the (N, 1, 1, T) padding mask -------------------------
        causal_attention_mask = None
        if not cfg.causal:
            T_DST = T_SRC = attention_mask.shape[-1]
            dst_attention_mask = attention_mask.transpose(-1, -2)
        elif attention_mask.shape[-1] == 1:
            if not cfg.use_fused_train or truths or not (benchmarking or use_fused_train):
                raise ValueError(
                    "the thin causal mask requires the fused-train path (no KD loss)"
                )
            T_DST = T_SRC = attention_mask.shape[-2]
            dst_attention_mask = attention_mask
            attention_mask = attention_mask.transpose(-1, -2)
        else:
            causal_attention_mask = attention_mask
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

        # --- 5 "mask_softmax" + the estimator's KD losses ---------------------
        with bench.region("mask_softmax"):
            estimated_attention_probs = softmax_fp32(estimated_attention_score, -1)
        bench.register_temp_buffer("estimated_attention_score", estimated_attention_score)
        bench.register_temp_buffer("estimated_attention_probs", estimated_attention_probs)

        # every resize of one forward reads one column map: the mask and the
        # jitter's draws are the same for each (as in the JAX module, whose
        # resizes split one rng alike)
        index = None

        def resize(x, fill, handle_oversample):
            nonlocal index
            if index is None:
                index = resize_index(
                    causal_attention_mask if cfg.causal else attention_mask, T_M,
                    jitter if (training and cfg.causal) else None,
                )
            return resize_with_index(
                x, fill, index, cfg.effective_k,
                cfg.k_oversample if handle_oversample else None,
            )

        loss = torch.zeros((), dtype=torch.float32, device=q.device)
        estimated_attention_probs_resized = None
        if not benchmarking and attention_scores_truth is not None:
            estimated_attention_probs_resized = resize(estimated_attention_probs, 0.0, False)
            estimated_attention_score_resized = resize(
                estimated_attention_score, FP_MIN, False).float()
            loss = loss + self._scores_kd_loss(
                estimated_attention_score_resized, attention_scores_truth,
                causal_attention_mask, attention_mask, FP_MIN,
            )
            bench.register_temp_buffer(
                "estimated_attention_probs_resized", estimated_attention_probs_resized
            )

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

        partial_attention_probs = dense_attention_probs = None
        if benchmarking or use_fused_train:
            partial_attention_mask = partial_attention_mask_m
            partial_context_layer, estimated_scales = self._fused_attention(
                q_for_score, k_for_score, v, partial_attention_mask_m,
                t_attention_predictor, zero_one_attention_mask, T_DST, T_SRC, benchmarking,
            )
        else:
            # --- 7 "interp": the compressed mask resized to (T_DST, T_SRC) ---
            with bench.region("interp"):
                partial_attention_mask = resize(partial_attention_mask_m, FP_MIN, True)
                if cfg.causal:
                    partial_attention_mask = partial_attention_mask.masked_fill(
                        causal_attention_mask < -1, FP_MIN)

            # --- 8 "attention": dense scores, the truth's KD loss, the masked
            # softmax, the row scaler and P·V ----------------------------------
            with bench.region("attention"):
                estimated_scales = self.dec_scaler(t_attention_predictor)
                bench.register_temp_buffer("estimated_scales", estimated_scales)
                attention_scores_dense = torch.einsum(
                    "nhtd,nhsd->nhts", q_for_score, k_for_score)
                if attention_scores_truth is not None:
                    if not cfg.causal:
                        # only here, as in the JAX module: the BERT scores
                        # take 1/sqrt(D) on the KD path alone
                        attention_scores_dense = attention_scores_dense / math.sqrt(D)
                    loss = loss + self._scores_kd_loss(
                        attention_scores_dense.float(), attention_scores_truth,
                        causal_attention_mask, attention_mask, FP_MIN,
                    )
                bench.register_temp_buffer("attention_scores_dense", attention_scores_dense)
                amask = causal_attention_mask if cfg.causal else attention_mask
                dense_attention_probs = softmax_fp32(attention_scores_dense + amask, -1)
                partial_attention_scores = attention_scores_dense + partial_attention_mask
                partial_attention_probs = softmax_fp32(partial_attention_scores, -1)
                partial_attention_probs = partial_attention_probs.masked_fill(
                    partial_attention_mask < -1, 0.0)
                bench.register_temp_buffer("partial_attention_scores", partial_attention_scores)
                bench.register_temp_buffer("attention_matrix", partial_attention_probs)
                if cfg.partial_attention_scaler:
                    partial_attention_probs = partial_attention_probs * torch.sigmoid(
                        estimated_scales[..., 0:1])
                partial_context_layer = torch.einsum(
                    "nhts,nhsd->nhtd", partial_attention_probs, v)

        # --- 9 "attention.avg_pool": mix with the average context ------------
        with bench.region("attention.avg_pool"):
            if cfg.causal:
                avg_v = v * dst_alive.to(v.dtype)
                denom = torch.arange(
                    1, T_SRC + 1, dtype=torch.float32, device=v.device
                ).reshape(1, 1, -1, 1)
                average_context_layer = (
                    torch.cumsum(avg_v.float(), dim=-2) / denom
                ).to(v.dtype)
                if average_context_layer.shape[-2] > T_DST:
                    average_context_layer = average_context_layer[..., -T_DST:, :]
            else:
                # the estimate's mean over every row, padded rows included
                # (as in the JAX package), resized to T columns: one weight
                # per key, zero at padding
                mean_probs = estimated_attention_probs.mean(-2, keepdim=True)
                w = resize(mean_probs, 0.0, False).transpose(-1, -2)
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
        if not benchmarking and context_layer_truth is not None:
            loss = loss + torch.mean(
                (context_layer_truth.float() - partial_context_layer.float()) ** 2
            )
        bench.register_temp_buffer("partial_context_layer", partial_context_layer)
        return SeaAttentionOutput(
            loss=loss,
            context_layer=partial_context_layer,
            partial_attention_probs=partial_attention_probs,
            partial_attention_mask=partial_attention_mask,
            estimated_attention_probs_m=estimated_attention_probs,
            estimated_attention_probs=(
                estimated_attention_probs if benchmarking or use_fused_train
                else estimated_attention_probs_resized
            ),
            dense_attention_probs=dense_attention_probs,
            key_for_score=k_for_score,
            state=None,
        )

    def _fused_attention(self, q_for_score, k_for_score, v, partial_attention_mask_m,
                         t_attention_predictor, zero_one_attention_mask, T_DST, T_SRC,
                         benchmarking):
        """Stages 7-8 in one launch of a fused kernel: mask expansion,
        tile-skipped masked softmax, P·V and the row scaler. The benchmark
        path takes the forward kernel on the binary mask (K1 causal, K5
        non-causal), task-only training the differentiable one on the
        additive mask (K2-K4), each sharded by the scope's kind. Returns the
        (N, H, T_DST, D) context and the gate head's (N, H, T_DST, 2)
        estimated scales."""
        cfg = self.cfg
        bench = get_bench()
        N, H, _, D = q_for_score.shape
        dtype, device = q_for_score.dtype, q_for_score.device
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
                mask_bin = (partial_attention_mask_m > 0).to(dtype)
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
                mask_bin = (partial_attention_mask_m > -1.0).to(dtype)
                if row_scaler is None:
                    row_scaler = torch.ones((N, H, T_DST), dtype=dtype, device=device)
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
        return partial_context_layer, estimated_scales

    def _scores_kd_loss(self, scores, truth, causal_attention_mask, attention_mask, fp_min):
        """A KD loss of float32 (N, H, T, T) scores against the teacher's:
        0.1 · KL(softmax(truth) ‖ softmax(scores)) plus the mean squared
        difference of the two softmaxes, dead entries set to FP_MIN on both
        sides first. Causal: the KL is `F.kl_div(reduction='batchmean')` over
        every row; non-causal: summed over the kept (row, column) pairs of
        the padding mask and divided by the kept rows."""
        truth = truth.float()
        if self.cfg.causal:
            dead = causal_attention_mask < -1
        else:
            dead = attention_mask < -1
        est = scores.masked_fill(dead, fp_min)
        tru = truth.masked_fill(dead, fp_min)
        log_input = torch.log_softmax(est, -1)
        target = torch.softmax(tru, -1)
        if self.cfg.causal:
            kl = _kl_div_batchmean(log_input, target)
        else:
            kl = _kl_div_attention(log_input, target, attention_mask)
        return kl * 0.1 + torch.mean((torch.softmax(est, -1) - target) ** 2)

