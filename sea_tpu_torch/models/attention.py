"""SEA attention core (PyTorch port): estimator -> top-k mask -> sparse attention.

Port of the causal fused paths of `sea_tpu/models/attention.py`
(`SeaAttention`), stage for stage, with the same profiler region and buffer
names:

  1 "vmask"           identity-value construction, v_for_atten = [id ‖ v]
  2 "performer"       FAVOR+ linear attention over (q, k, v_for_atten), fp32
  3 "performer_value" concat [performer_ctx ‖ v]
  4 "predictor"       enc MLP -> dec_row + ChannelSplit -> causal CNN -> score
  5 "mask_softmax"    softmax of the estimate
  6 "mask"            grouped top-k over (N, T_DST, H·T_M) with per-row budget
  7-8 "attention.fused"  the fused causal sparse kernel
  9 "attention.avg_pool" mix with the running-average context, per-query gate

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

Not ported yet, and refused with NotImplementedError rather than routed
elsewhere: the dense differentiable train path and its KD losses
(`benchmarking=False` without `use_fused_train`), the non-causal (BERT)
module, the uniform-CSR path (`use_pallas=False`), the cosformer backend,
the 'comp' predictor, `enc_per_layer`, LoRA, the sequence-sharded and ring
train kernels, and the decode cache.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SeaConfig
from ..ops.kernels.block_sparse import fused_sparse_attention, sea_block_sparse_attention
from ..ops.masks import fp_min_for, per_item_top_k, topk_mask
from ..ops.performer import fast_attention, gaussian_orthogonal_random_matrix
from ..utils.profiler import get_bench
from .modules import CausalConv2d, ChannelSplit, interpolate, upsample_nearest


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
                m.v_eye_learned_causal.copy_(randn(m.v_eye_learned_causal.shape))


class SeaAttention(nn.Module):
    """The SEA attention module, one per transformer layer (causal). Built on
    `device` with seeded random weights (`seed=None` leaves them
    uninitialised, for `load_state_dict` or a parent's init)."""

    def __init__(self, cfg: SeaConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if not cfg.causal:
            raise NotImplementedError("the non-causal SEA module is not ported yet")
        if cfg.predictor_method != "mlp" or cfg.predictor_backend != "performer":
            raise NotImplementedError(
                "only predictor_method='mlp' with the performer backend is ported"
            )
        if cfg.enc_per_layer or cfg.lora_enabled or cfg.lora_in_approx_enabled:
            raise NotImplementedError("enc_per_layer and LoRA are not ported yet")
        self.cfg = cfg
        D, H, T_M = cfg.head_dim, cfg.num_heads, cfg.predictor_length

        # FAVOR+ projection: a buffer, not a parameter (redrawn, never trained)
        self.register_buffer(
            "performer_proj",
            torch.empty(cfg.nb_features, D),
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
        # causal CNN: LN -> 2x dilated causal conv -> up(1,4) -> 1x1 conv
        # (padding 1 widens T_M to T_M+2) -> area resize back to T_M -> LN
        ch = splits * H
        self.cnn_ln1 = _layer_norm(T_M // down)
        self.cnn_conv1 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
        self.cnn_conv2 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
        if cfg.cnn_deeper:
            self.cnn_conv3 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
        self.cnn_conv4 = CausalConv2d(ch, H, 1, padding=1, causal=True)
        self.cnn_ln2 = _layer_norm(T_M)
        # per-query two-channel gate head
        self.dec_scaler = nn.Linear(2 * D, 2)
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

    def _identity_values(self, v_for_atten: torch.Tensor, t_src: int) -> torch.Tensor:
        """Stage 1 "vmask": a slice of the learned positional table."""
        N, H, _, D = v_for_atten.shape
        v_id = self.v_eye_learned_causal[:, :, :t_src, :].to(v_for_atten.dtype)
        return v_id.expand(N, H, t_src, D)

    def _predictor_cnn(self, x: torch.Tensor) -> torch.Tensor:
        """Stage 4 CNN. x: (N, C, T, T_M/down) -> (N, H, T, T_M)."""
        cfg = self.cfg
        T_M = cfg.predictor_length

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

        # --- mask plumbing: the (N, 1, T, T) additive causal mask, or its thin
        # (N, 1, T, 1) dst column; every consumer below reads only the dst and
        # src padding slices, and the kernels derive causality themselves ----
        if attention_mask.shape[-1] == 1:
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
            v_id = self._identity_values(v_for_atten, T_SRC)
            v_for_atten = torch.cat([v_id, v_for_atten], dim=-1)
            v_for_atten = torch.where(dst_alive, v_for_atten, torch.zeros_like(v_for_atten))
            v = torch.where(dst_alive, v, torch.zeros_like(v))
            bench.register_temp_buffer("v_for_atten", v_for_atten)

        # --- 2 "performer" (float32) ---------------------------------------
        with bench.region("performer"):
            performer_context_layer = fast_attention(
                q_for_atten.float(),
                k_for_atten.float(),
                v_for_atten.float(),
                self.performer_proj,
                causal=True,
                generalized=True,
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
            ).reshape(1, T_DST, 1).expand(N, T_DST, 1)
            budget = per_item_top_k(
                cfg_k=cfg.effective_k,
                k_oversample=cfg.k_oversample,
                k_flatten_dim=cfg.k_flatten_dim,
                num_heads=H,
                t_m=T_M,
                token_length=token_length,
                causal_token_length=causal_token_length,
                causal=True,
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
            if benchmarking:
                mask_bin = (partial_attention_mask_m > 0).to(q.dtype)
                partial_context_layer = sea_block_sparse_attention(
                    q_for_score,
                    k_for_score,
                    v,
                    mask_bin,
                    row_scaler,
                    is_causal=True,
                    block_q=cfg.block_q,
                    oversample=cfg.k_oversample,
                    k_cfg=float(cfg.effective_k),
                )
            else:
                mask_bin = (partial_attention_mask_m > -1.0).to(q.dtype)
                if row_scaler is None:
                    row_scaler = torch.ones((N, H, T_DST), dtype=q.dtype, device=q.device)
                partial_context_layer = fused_sparse_attention(
                    q_for_score, k_for_score, v, mask_bin, row_scaler,
                    block_q=cfg.block_q,
                )
            # the kernel's output, whose gradient is the backward kernels' dO
            bench.register_temp_buffer("fused_attention_output", partial_context_layer)
        with bench.region("attention.avg_pool"):
            avg_v = v * dst_alive.to(v.dtype)
            denom = torch.arange(
                1, T_SRC + 1, dtype=torch.float32, device=v.device
            ).reshape(1, 1, -1, 1)
            average_context_layer = (torch.cumsum(avg_v.float(), dim=-2) / denom).to(v.dtype)
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
