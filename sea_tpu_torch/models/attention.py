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

The decode cache (`cfg.use_cache`, causal, performer backend): `init_state`,
`decode` (one step against a contiguous K/V cache), `decode_paged` (one step
against a paged K/V pool, float32 or int8, the serving engine's) and
`prefill_state` (the cache of a whole prompt in one pass). A step runs
stages 1-8 on one row: the FAVOR+ prefix step, the predictor on a 24-row
window of CNN inputs, the per-row top-k, the row mask resized to the cache
width by decode's own pixel rule, and dense row attention against the cache
(plain PyTorch: no kernel, as in JAX).

Types are the JAX module's: every stage runs in the type of q, k, v and
the parameters (`Dense`, `LayerNorm` and the einsums promote a mix to the
wider type), with the JAX module's float32 islands: the performer (or
cosformer), `softmax_fp32`, the convolutions and resizes, the average
context's running sum, the KD losses, and the decode state's FAVOR+ sums and
running sum. bfloat16 operands take K1-K4's bf16 instances; the ring's
windowed kernels (K6-K8) take float32 only.

`kd_self_teacher` trains the dense path against the student's own detached
dense scores (plus the mask) when no teacher truth is given.

The uniform-CSR benchmark path (`ops/flat_csr.py`, plain PyTorch as in
JAX) runs stages 7-8 when `benchmarking` and `use_pallas=False`, or, as
JAX's `use_fused` predicate routes it, for the non-causal module with
`k_oversample != 1`: the compressed mask expanded to a `UniformCsr` by
round-half-away ("interp"), then the masked score product (with 1/sqrt(D)
non-causal), the per-(row, head) softmax, the row scaler and the sparse
product with V ("attention"). It launches no kernel; it is a parity and
debug path, and nothing falls back to it.

The predictor is the MLP encoder above (`predictor_method='mlp'`; with
`enc_per_layer` one encoder over the heads concatenated, (N, T, H·3D) ->
(N, T, H·2D)) or the codebook ('comp': an encoder, `comp_dec_row` to
`comp_patch_count` softmaxes over `comp_book_size` codes, each code a
`comp_patch_size`-wide row of `comp_codebook`; no CNN, no `query_skips`).
As in JAX, decode and `prefill_state` take the 'mlp' predictor only and
read `enc_dense` even under `enc_per_layer` (so the module keeps
`enc_dense`/`enc_ln` beside the per-layer encoder when `use_cache`).
LoRA lives in the models' projections (`models/lora.py`), not here.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SeaConfig
from ..ops.kernels.block_sparse import _div, fused_sparse_attention, sea_block_sparse_attention
from ..ops import flat_csr
from ..ops.cosformer import CosformerAttention
from ..ops.masks import (
    _ranks_desc,
    fp_min_for,
    per_item_top_k,
    resize_index,
    resize_with_index,
    topk_mask,
)
from ..ops.performer import (
    causal_linear_attention,
    fast_attention,
    gaussian_orthogonal_random_matrix,
    relu_kernel_features,
)
from ..parallel import sharded_attention as sharded
from ..parallel.context import (AttnShardingContext, current_attention_sharding,
                                resolve_attention_kind)
from ..utils.profiler import get_bench
from .lora import LoraDelta
from .modules import (
    CausalConv2d,
    ChannelSplit,
    Dense,
    KeepRes,
    LayerNorm,
    RMSNorm,
    einsum,
    gelu,
    interpolate,
    upsample_nearest,
)
from .state import (
    CNN_WINDOW,
    SeaDecodeState,
    cnn_window_push,
    cumavg_step,
    dequantize_kv,
    init_decode_state,
    performer_decode_step,
    quantize_kv,
)


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


def _rowwise_update(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """`cache` (N, H, S, D) with `new` (N, H, 1, D) written at each row's own
    position `pos` (N,), out of place: a caller's earlier state keeps its
    cache (the serving engine's frozen slots, beam search's parents)."""
    index = pos.long().reshape(-1, 1, 1, 1).expand(new.shape)
    return cache.scatter(2, index, new.to(cache.dtype))


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


def _layer_norm(features: int) -> LayerNorm:
    # flax's LayerNorm: epsilon 1e-6, not torch's 1e-5, and its type rule
    return LayerNorm(features)


def init_random_(root: nn.Module, generator: torch.Generator):
    """Seeded random init of every parameter and buffer under `root`, drawn
    from `generator` on its device (a CPU generator gives the same weights
    on every device; the models draw on the CPU): linears N(0, 1/fan_in)
    with zero bias, embeddings N(0, 1/features), LayerNorms and RMSNorms the
    identity, causal convs U(±1/sqrt(fan_in)), each SEA module's FAVOR+
    projection, identity-value table and codebook (N(0, 1)), and each LoRA
    delta's own init (A kaiming-uniform, B zero)."""

    def randn(shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    with torch.no_grad():
        for m in root.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(randn(m.weight.shape) * m.weight.shape[1] ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(randn(m.weight.shape) * m.weight.shape[1] ** -0.5)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, CausalConv2d):
                m.reset_parameters(generator)
            elif isinstance(m, SeaAttention):
                m.performer_proj.copy_(gaussian_orthogonal_random_matrix(
                    generator, m.cfg.nb_features, m.cfg.head_dim, device=generator.device
                ))
                if m.cfg.causal:
                    m.v_eye_learned_causal.copy_(randn(m.v_eye_learned_causal.shape))
                if m.cfg.predictor_method == "comp":
                    m.comp_codebook.copy_(randn(m.comp_codebook.shape))
            elif isinstance(m, LoraDelta):
                m.reset_parameters(generator)
            elif hasattr(m, "performer_proj"):
                # a baseline performer's (or scatterbrain's) projection
                m.performer_proj.copy_(gaussian_orthogonal_random_matrix(
                    generator, *m.performer_proj.shape, device=generator.device))


class SeaAttention(nn.Module):
    """The SEA attention module, one per transformer layer. Built on
    `device` with seeded random weights (`seed=None` leaves them
    uninitialised, for `load_state_dict` or a parent's init). Only the
    modules the JAX package's forward builds for `cfg` exist, so that its
    variable trees map one to one; with `enc_per_layer` and `use_cache` also
    `enc_dense`/`enc_ln`, which decode reads (as a JAX tree initialised
    through the prefill has them)."""

    # the shard group of a tensor-parallel model (`parallel.tp.tensor_parallel`):
    # the fused causal paths run on each of its positions' heads (the 'head'
    # kind) when no sharding scope is active
    head_group = None

    def __init__(self, cfg: SeaConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if cfg.predictor_method not in ("mlp", "comp"):
            raise ValueError(f"predictor_method {cfg.predictor_method!r}")
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

        mlp = cfg.predictor_method == "mlp"
        # predictor encoder: Linear(3D -> 2D) + LN + GELU (decode's even
        # under enc_per_layer)
        if mlp and (not cfg.enc_per_layer or cfg.use_cache):
            self.enc_dense = Dense(3 * D, 2 * D)
            self.enc_ln = _layer_norm(2 * D)
        if mlp and cfg.enc_per_layer:
            # one encoder over the heads concatenated
            self.enc_per_layer_dense = Dense(3 * D * H, 2 * D * H)
            self.enc_per_layer_ln = _layer_norm(2 * D * H)
        if cfg.predictor_method == "comp":
            self.comp_codebook = nn.Parameter(
                torch.empty(cfg.comp_book_size, cfg.comp_patch_size))
            self.comp_enc_dense = Dense(3 * D, 2 * D)
            self.comp_enc_ln = _layer_norm(2 * D)
            self.comp_dec_row = Dense(2 * D, cfg.comp_book_size * cfg.comp_patch_count)
        # decoder row projector + channel split
        splits = cfg.splits
        down = cfg.dec_row_down_scale
        if mlp:
            self.dec_row = Dense(2 * D, (T_M // down) * splits)
        self.channel_split = ChannelSplit(splits)
        ch = splits * H
        if mlp and cfg.causal:
            # LN -> 2x dilated causal conv -> up(1,4) -> 1x1 conv (padding 1
            # widens T_M to T_M+2) -> area resize back to T_M -> LN
            self.cnn_ln1 = _layer_norm(T_M // down)
            self.cnn_conv1 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
            self.cnn_conv2 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
            if cfg.cnn_deeper:
                self.cnn_conv3 = CausalConv2d(ch, ch, 3, padding=2, dilation=2, causal=True)
            self.cnn_conv4 = CausalConv2d(ch, H, 1, padding=1, causal=True)
            self.cnn_ln2 = _layer_norm(T_M)
        elif mlp:
            # strided conv (2, 1) -> conv -> nearest up (2, 1) -> conv, then
            # a resize to (T, T_M) (linear widening of T_M/2)
            self.cnn_conv1 = CausalConv2d(ch, 4 * H, 3, padding=1, stride=(2, 1))
            self.cnn_conv2 = CausalConv2d(4 * H, 4 * H, 3, padding=1)
            self.cnn_conv3 = CausalConv2d(4 * H, H, 3, padding=1)
        # per-query two-channel gate head
        self.dec_scaler = Dense(2 * D, 2)
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
        # a self-teacher student (below) trains against its own scores
        truths = (attention_scores_truth is not None or context_layer_truth is not None
                  or (cfg.kd_self_teacher and training))
        # task-only training through the differentiable fused kernel
        use_fused_train = (
            not benchmarking
            and cfg.causal
            and cfg.use_fused_train
            and cfg.use_pallas
            and not truths
            and cfg.k_oversample == 1.0
        )
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

        # the self-teacher: the student's own detached dense scores as its
        # truth (no context truth)
        if cfg.kd_self_teacher and attention_scores_truth is None and training:
            attention_scores_truth = torch.einsum(
                "nhtd,nhsd->nhts", q_for_score.detach(), k_for_score.detach()
            ) + (causal_attention_mask if cfg.causal else attention_mask)
            context_layer_truth = None

        bench.register_temp_buffer("q", q)
        bench.register_temp_buffer("k", k)
        bench.register_temp_buffer("v", v)
        # the scores' q and k (LoRA's estimator branch makes them differ
        # from q and k): the fused kernels' inputs
        bench.register_temp_buffer("q_for_score", q_for_score)
        bench.register_temp_buffer("k_for_score", k_for_score)

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
            if cfg.predictor_method == "comp":
                t_attention_predictor, estimated_attention_score = self._comp_predictor(
                    performer_value)
            else:
                t_attention_predictor, estimated_attention_score = self._mlp_predictor(
                    performer_value)
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
        if benchmarking and not (cfg.use_pallas and (cfg.causal or cfg.k_oversample == 1.0)):
            # --- 7-8 the uniform-CSR chain (JAX's use_fused predicate) ----
            partial_attention_mask, partial_attention_probs, partial_context_layer, \
                estimated_scales = self._csr_attention(
                    q_for_score, k_for_score, v, partial_attention_mask_m,
                    t_attention_predictor, T_SRC)
        elif benchmarking or use_fused_train:
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

    def _mlp_predictor(self, performer_value: torch.Tensor):
        """Stage 4, 'mlp': the encoder on every `query_skips`-th row (per
        head, or with `enc_per_layer` over the heads concatenated), dec_row,
        the channel split and the CNN, each row then repeated. Returns the
        encoder's (N, H, T, 2D) output and the (N, H, T, T_M) scores."""
        cfg = self.cfg
        s = cfg.query_skips
        x = performer_value
        if s > 1:
            assert x.shape[2] % s == 0
            x = x[:, :, ::s, :]
        if cfg.enc_per_layer:
            N, H, T, D3 = x.shape
            flat = x.permute(0, 2, 1, 3).reshape(N, T, H * D3)
            enc = gelu(self.enc_per_layer_ln(self.enc_per_layer_dense(flat)))
            t_pred = enc.reshape(N, T, H, -1).permute(0, 2, 1, 3)
        else:
            t_pred = gelu(self.enc_ln(self.enc_dense(x)))
        # (N, H, T', out_ch) read as NCHW -> ChannelSplit -> CNN
        score = self._predictor_cnn(self.channel_split(self.dec_row(t_pred)))
        if s > 1:
            score = torch.repeat_interleave(score, s, dim=2)
            t_pred = torch.repeat_interleave(t_pred, s, dim=2)
        return t_pred, score

    def _comp_predictor(self, performer_value: torch.Tensor):
        """Stage 4, 'comp': the encoder, then `comp_patch_count` float32
        softmaxes over the codebook's `comp_book_size` codes, each patch
        the probability-weighted mix of the codes' rows. Returns the
        encoder's output and the (N, H, T, count · patch) scores."""
        cfg = self.cfg
        N, H, T, _ = performer_value.shape
        t_pred = gelu(self.comp_enc_ln(self.comp_enc_dense(performer_value)))
        code = self.comp_dec_row(t_pred).reshape(
            N, H, T, cfg.comp_patch_count, cfg.comp_book_size)
        code = softmax_fp32(code, -1)
        score = einsum("nhtpb,bs->nhtps", code, self.comp_codebook).reshape(N, H, T, -1)
        return t_pred, score

    def _csr_attention(self, q_for_score, k_for_score, v, partial_attention_mask_m,
                       t_attention_predictor, T_SRC):
        """Stages 7-8 on the uniform CSR: the binary compressed mask expanded
        by round-half-away ("interp"), then the masked score product (scaled
        by 1/sqrt(D) non-causal), the segment softmax, the row scaler and
        the sparse product with V ("attention"). Returns the CSR mask, the
        CSR probabilities, the (N, H, T_DST, D) context and the gate head's
        estimated scales."""
        cfg = self.cfg
        bench = get_bench()
        D = q_for_score.shape[-1]
        with bench.region("interp"):
            csr_mask = flat_csr.resize_from_m_to_t_csr(
                partial_attention_mask_m, cfg.effective_k, T_SRC, is_causal=cfg.causal,
                max_nnz=cfg.max_nnz_for(T_SRC))
        with bench.region("attention"):
            estimated_scales = self.dec_scaler(t_attention_predictor)
            bench.register_temp_buffer("estimated_scales", estimated_scales)
            csr = flat_csr.flat_csr_masked_bmm(q_for_score, k_for_score, csr_mask)
            if not cfg.causal:
                # a true division (a CUDA division by a Python number takes
                # the reciprocal)
                csr = csr.replace(values=csr.values / torch.full_like(
                    csr.values, math.sqrt(D)))
            csr = flat_csr.flat_csr_softmax(csr)
            if cfg.partial_attention_scaler:
                csr = flat_csr.flat_csr_elmul(csr, torch.sigmoid(estimated_scales[..., 0]))
            context = flat_csr.flat_csr_sdbmm(csr, v)
        return csr_mask, csr, context, estimated_scales

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
            if shard_ctx is None and cfg.causal and self.head_group is not None:
                # a tensor-parallel model: each position's own heads
                shard_ctx = AttnShardingContext(group=self.head_group, kind="head")
            kind = None if shard_ctx is None else resolve_attention_kind(
                shard_ctx, t=T_SRC, oversample=cfg.k_oversample)
            if benchmarking:
                mask_bin = (partial_attention_mask_m > 0).to(dtype)
                if cfg.causal:
                    q_kern, lengths = q_for_score, None
                else:
                    # the BERT path scales the scores by 1/sqrt(D), sqrt(D) in
                    # q's type as JAX's weak float is: a true division, since a
                    # CUDA tensor divided by a Python number is multiplied by
                    # the reciprocal, which is inexact at D = 32 (LRA image)
                    q_kern = _div(q_for_score, math.sqrt(D))
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


    # ------------------------------------------------------------------
    # the decode cache
    def _check_decode(self):
        cfg = self.cfg
        if not cfg.use_cache:
            raise ValueError("decode needs SeaConfig(use_cache=True)")
        if cfg.predictor_method != "mlp":
            raise NotImplementedError(
                "decode and prefill_state take predictor_method='mlp' only, as the JAX "
                "package's do (it asserts it)")
        if not cfg.causal or cfg.predictor_backend != "performer":
            raise ValueError(
                "the decode cache is causal and carries the FAVOR+ prefix only "
                "(predictor_backend='performer')"
            )

    def init_state(self, batch: int, max_len: int, dtype=torch.float32) -> SeaDecodeState:
        """An empty decode state for `batch` rows and a `max_len`-token cache,
        on this module's device."""
        cfg = self.cfg
        return init_decode_state(
            batch, cfg.num_heads, cfg.head_dim, cfg.nb_features, cfg.predictor_length,
            cfg.splits, cfg.dec_row_down_scale, max_len, dtype,
            device=self.performer_proj.device,
        )

    def decode(
        self,
        q: torch.Tensor,  # (N, H, 1, D), pre-scaled like the forward's q
        k: torch.Tensor,
        v: torch.Tensor,
        state: SeaDecodeState,
    ) -> Tuple[torch.Tensor, SeaDecodeState]:
        """One autoregressive step against the contiguous cache: the same
        result as the dense forward's last row (the FAVOR+ state is the exact
        prefix sum, the CNN window covers the stack's receptive field).
        Returns ((N, 1, H·D), the new state)."""
        row_mask, t_pred, S, z, window, filled, pos_b = self._decode_common(q, k, v, state)
        # the K/V cache written at each row's own position (lockstep rows
        # share one, serving slots each have their own)
        k_cache = _rowwise_update(state.k_cache, k, pos_b)
        v_cache = _rowwise_update(state.v_cache, v, pos_b)
        # stage 8: dense row attention against the cache
        scores = einsum("nhtd,nhsd->nhts", q, k_cache) + row_mask
        out, cum_sum, cum_len = self._decode_mix(scores, row_mask, v_cache, t_pred, state, v)
        return out, SeaDecodeState(
            performer_S=S, performer_z=z, cnn_window=window, cnn_filled=filled,
            cumavg_sum=cum_sum, cumavg_len=cum_len, k_cache=k_cache, v_cache=v_cache,
            length=state.length + 1,
        )

    def decode_paged(
        self,
        q: torch.Tensor,  # (N, H, 1, D)
        k: torch.Tensor,
        v: torch.Tensor,
        state: SeaDecodeState,  # k_cache / v_cache may be zero-width (N, H, 0, D)
        pool_k,  # (P, page_size, H, D), or an (int8 data, float32 scale) pair
        pool_v,
        pages: torch.Tensor,  # (N, max_pages) page ids, position-major
    ):
        """One step against a paged K/V pool (the serving path). Token t of
        row n lives at (pages[n, t // page_size], t % page_size); unallocated
        pages may point at a dummy page, which the length-derived row mask
        keeps out of the softmax. The arithmetic is `decode`'s; only the
        cache layout differs.

        The pools are written in place (each row's new K/V at its position)
        and returned: (out, new_state, pool_k, pool_v). An int8 pool is an
        (int8 data, float32 per-(token, head) scale) pair (`quantize_kv`): new
        K/V are quantised on write and the gathered pages dequantised on
        read."""
        page_size = (pool_k[0] if isinstance(pool_k, tuple) else pool_k).shape[1]
        row_mask, t_pred, S, z, window, filled, pos_b = self._decode_common(
            q, k, v, state, max_len=pages.shape[1] * page_size
        )
        return self.paged_attend(q, k, v, row_mask, t_pred, (S, z, window, filled), state,
                                 pool_k, pool_v, pages, pos_b)

    def paged_attend(self, q, k, v, row_mask, t_pred, step, state: SeaDecodeState, pool_k,
                     pool_v, pages, pos_b):
        """`decode_paged` after the row mask: the new K/V written into the
        pools, the masked row attention against the pages and the average
        mix, on whichever heads q, k, v, the mask, the pools and the state
        hold (a head-sharded engine calls it on each position's). `step` is
        `_decode_rows`' (S, z, window, filled). Returns (out (N, 1, H·D),
        new state, pool_k, pool_v)."""
        S, z, window, filled = step
        quant = isinstance(pool_k, tuple)
        if quant:
            (pool_k, pool_k_scale), (pool_v, pool_v_scale) = pool_k, pool_v
        page_size = pool_k.shape[1]
        N, H, _, D = q.shape
        mp = pages.shape[1]

        # the new K/V written at (page, offset) per row
        pages = pages.long()
        pos = pos_b.long()
        page_ids = torch.gather(pages, 1, (pos // page_size)[:, None])[:, 0]
        offsets = pos % page_size
        if quant:
            qk, sk = quantize_kv(k[:, :, 0, :])
            qv, sv = quantize_kv(v[:, :, 0, :])
            pool_k[page_ids, offsets] = qk
            pool_v[page_ids, offsets] = qv
            pool_k_scale[page_ids, offsets] = sk
            pool_v_scale[page_ids, offsets] = sv
            k_pages = dequantize_kv(pool_k[pages], pool_k_scale[pages], q.dtype)
            v_pages = dequantize_kv(pool_v[pages], pool_v_scale[pages], q.dtype)
        else:
            pool_k[page_ids, offsets] = k[:, :, 0, :].to(pool_k.dtype)
            pool_v[page_ids, offsets] = v[:, :, 0, :].to(pool_v.dtype)
            k_pages = pool_k[pages]  # (N, mp, ps, H, D)
            v_pages = pool_v[pages]
        # position-major pages: the flattened (mp, ps) axis is a contiguous
        # cache of width mp·ps
        scores = einsum("nhtd,npshd->nhtps", q, k_pages).reshape(N, H, 1, mp * page_size)
        scores = scores + row_mask
        out, cum_sum, cum_len = self._decode_mix(scores, row_mask, v_pages, t_pred, state, v)
        new_state = SeaDecodeState(
            performer_S=S, performer_z=z, cnn_window=window, cnn_filled=filled,
            cumavg_sum=cum_sum, cumavg_len=cum_len, k_cache=state.k_cache,
            v_cache=state.v_cache, length=state.length + 1,
        )
        if quant:
            return out, new_state, (pool_k, pool_k_scale), (pool_v, pool_v_scale)
        return out, new_state, pool_k, pool_v

    def prefill_state(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, max_len: int
    ) -> SeaDecodeState:
        """The decode cache of a whole prompt (N, H, P, D) in one pass, in
        place of P `decode` steps (same conventions: q pre-scaled). Each
        field is the parallel form of the sequential updates: S and z the
        prefix sums of the causal linear attention, the window the last 24
        per-position predictor rows (dec_row is pointwise), the sum of v, and
        K/V at positions [0, P); float sums run in another order than the
        sequential loop's."""
        self._check_decode()
        N, H, P, D = q.shape
        if P > max_len:
            raise ValueError(f"a prompt of {P} tokens does not fit a {max_len}-token cache")

        # stage 1: identity value rows for positions [0, P)
        v_id = self.v_eye_learned_causal[0, 0, :P]
        v_for_atten = torch.cat([v_id[None, None].to(v.dtype).expand(N, H, P, D), v], dim=-1)

        # stage 2: causal FAVOR+ over the prompt and its final (S, z)
        proj = self.performer_proj
        qp = relu_kernel_features(q, proj)
        kp = relu_kernel_features(k, proj)
        perf_ctx, (S, z) = causal_linear_attention(
            qp, kp, v_for_atten.float(), return_state=True
        )
        perf_ctx = perf_ctx.to(q.dtype)

        # stages 3-4: per-position predictor rows; the window keeps the last 24
        performer_value = torch.cat([perf_ctx, v], dim=-1)
        t_pred = gelu(self.enc_ln(self.enc_dense(performer_value)))
        rows = self.channel_split(self.dec_row(t_pred))  # (N, C, P, Wd)
        W = rows.shape[2]
        if W >= CNN_WINDOW:
            window = rows[:, :, W - CNN_WINDOW:, :]
        else:
            window = F.pad(rows, (0, 0, CNN_WINDOW - W, 0))

        def count(n):
            return torch.full((), n, dtype=torch.int32, device=q.device)

        k_cache = torch.zeros((N, H, max_len, D), dtype=k.dtype, device=k.device)
        v_cache = torch.zeros((N, H, max_len, D), dtype=v.dtype, device=v.device)
        k_cache[:, :, :P] = k
        v_cache[:, :, :P] = v
        return SeaDecodeState(
            performer_S=S,
            performer_z=z,
            cnn_window=window.float(),
            cnn_filled=count(min(P, CNN_WINDOW)),
            cumavg_sum=v.float().sum(dim=2, keepdim=True),
            cumavg_len=count(P),
            k_cache=k_cache,
            v_cache=v_cache,
            length=count(P),
        )

    def _decode_common(self, q, k, v, state: SeaDecodeState, max_len: Optional[int] = None):
        """Stages 1-7 of a step, whatever the cache layout: the identity
        value, the FAVOR+ prefix step, the predictor on the CNN window, the
        per-row top-k and the row mask resized to the cache width. Positions
        are () (lockstep) or (N,) (per slot); everything is per row."""
        if max_len is None:
            max_len = state.k_cache.shape[2]
        t_pred, S, z, window, filled, pos_b = self._decode_rows(q, k, v, state)
        row_mask = self.decode_row_mask(window, pos_b, max_len, q.dtype)
        return row_mask, t_pred, S, z, window, filled, pos_b

    def _decode_rows(self, q, k, v, state: SeaDecodeState):
        """Stages 1-4 up to the CNN's input, head by head: the identity
        value, the FAVOR+ prefix step, the encoder and dec_row, the row
        pushed into the window. Returns (t_pred, S, z, window, filled,
        pos_b) for the heads of q, k, v and the state (a head-sharded engine
        runs it on each position's)."""
        self._check_decode()
        bench = get_bench()
        N, H, _, D = q.shape
        pos_b = torch.broadcast_to(state.length, (N,))

        with bench.region("decode.performer"):
            # stage 1: the identity value row, gathered per row
            v_id = self.v_eye_learned_causal[0, 0].index_select(0, pos_b.long())  # (N, D)
            v_id = v_id[:, None, None, :].to(v.dtype).expand(N, H, 1, D)
            v_for_atten = torch.cat([v_id, v], dim=-1)
            # stage 2: the FAVOR+ prefix step (ReLU features, float32)
            proj = self.performer_proj
            qp = relu_kernel_features(q, proj)
            kp = relu_kernel_features(k, proj)
            perf_ctx, S, z = performer_decode_step(
                state.performer_S, state.performer_z, qp, kp, v_for_atten
            )
            perf_ctx = perf_ctx.to(q.dtype)

        with bench.region("decode.predictor"):
            # stage 3 and the CNN's row: the encoder, dec_row, the window
            performer_value = torch.cat([perf_ctx, v], dim=-1)
            t_pred = gelu(self.enc_ln(self.enc_dense(performer_value)))
            row = self.channel_split(self.dec_row(t_pred))  # (N, C, 1, Wd)
            window, filled = cnn_window_push(state.cnn_window, state.cnn_filled, row)
        return t_pred, S, z, window, filled, pos_b

    def decode_row_mask(self, window: torch.Tensor, pos_b: torch.Tensor, max_len: int,
                        dtype: torch.dtype) -> torch.Tensor:
        """Stages 4-7 on every head: the CNN on the window (splits·H
        head-major channels), the softmax, the row's grouped top-k over
        H·T_M and the (N, H, 1, max_len) additive row mask resized to the
        cache width. The heads mix here: a head-sharded engine gathers the
        window first."""
        cfg = self.cfg
        bench = get_bench()
        N = window.shape[0]
        H = cfg.num_heads
        T_M = cfg.predictor_length
        FP_MIN = fp_min_for(dtype)
        new_len = (pos_b + 1).float()  # (N,)
        device = window.device

        with bench.region("decode.predictor"):
            estimated_attention_score = self._predictor_cnn(window)[:, :, -1:, :]
            estimated_attention_probs = softmax_fp32(estimated_attention_score, -1)

        with bench.region("decode.mask"):
            # stage 6: the row's top-k, budget max(floor(H·k·os·T_M / new_len
            # + 0.5), 1), ties to the lower index (JAX's stable argsort)
            t = estimated_attention_probs.permute(0, 2, 1, 3).reshape(N, 1, H * T_M)
            # a true division by a tensor, never through a reciprocal
            num = torch.full_like(new_len, H * (cfg.effective_k * cfg.k_oversample * T_M))
            budget = torch.clamp(torch.floor(num / new_len + 0.5), min=1.0)  # (N,)
            ranks = _ranks_desc(t)
            dead_m = (ranks >= budget[:, None, None]).reshape(N, 1, H, T_M).permute(0, 2, 1, 3)
            fp_min = torch.full((), FP_MIN, dtype=dtype, device=device)
            mask_m = torch.where(dead_m, fp_min, torch.zeros_like(fp_min))
            bench.register_temp_buffer("decode_mask_m", mask_m)

        with bench.region("decode.interp"):
            # stage 7: the row resized to the cache width, decode's own pixel
            # rule floor((s + 0.5) / new_len · T_M − 1e-4), in this order
            s_idx = torch.arange(max_len, dtype=torch.float32, device=device)
            pix = torch.floor((s_idx[None, :] + 0.5) / new_len[:, None] * T_M - 1e-4).long()
            pix = torch.clamp(pix, 0, T_M - 1)  # (N, max_len)
            row_mask = torch.gather(mask_m[:, :, 0, :], -1,
                                    pix[:, None, :].expand(N, H, max_len))[:, :, None, :]
            alive_src = (s_idx[None, :] < new_len[:, None])[:, None, None, :]
            row_mask = torch.where(alive_src, row_mask, fp_min)
        return row_mask

    def _decode_mix(self, scores, row_mask, v_cache, t_pred, state: SeaDecodeState, v):
        """Stage 8 and the average mix, whatever the cache layout: the masked
        softmax, the row scaler, P·V and the running-average blend.
        `v_cache` is (N, H, S, D) contiguous or (N, mp, ps, H, D) paged."""
        cfg = self.cfg
        N, H, _, D = v.shape
        with get_bench().region("decode.attention"):
            probs = softmax_fp32(scores, -1)
            probs = probs.masked_fill(row_mask < -1, 0.0)
            estimated_scales = self.dec_scaler(t_pred)
            if cfg.partial_attention_scaler:
                probs = probs * torch.sigmoid(estimated_scales[..., 0:1])
            if v_cache.dim() == 5:  # paged (N, mp, ps, H, D)
                mp, ps = v_cache.shape[1], v_cache.shape[2]
                ctx = einsum("nhtps,npshd->nhtd", probs.reshape(N, H, 1, mp, ps), v_cache)
            else:
                ctx = einsum("nhts,nhsd->nhtd", probs, v_cache)

            # the running-average mix
            avg, cum_sum, cum_len = cumavg_step(state.cumavg_sum, state.cumavg_len, v)
            avg_scale = torch.sigmoid(estimated_scales[..., 1:2])
            ctx = ctx * avg_scale + (1 - avg_scale) * avg
        return ctx.permute(0, 2, 1, 3).reshape(N, 1, H * D), cum_sum, cum_len
