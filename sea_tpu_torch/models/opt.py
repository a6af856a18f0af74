"""OPT decoder with switchable attention (PyTorch port of `sea_tpu/models/opt.py`).

`attention_method` selects the self-attention of every layer:
  * 'perlin' — the SEA student (`SeaAttention`): forward on the fused
    benchmark path (`benchmarking=True`), task-only training through the
    differentiable fused kernel (`benchmarking=False` with
    `sea.use_fused_train`; `embed` then builds the thin causal mask), or the
    dense train path (otherwise), which takes the teacher's per-layer
    `LayerTeacherOutput` as its KD truths;
  * 'none'   — dense causal softmax attention: the KD teacher, whose layers
    return their captures (the clamped causal-masked scores and the
    context before `out_proj`), and the in-repo yardstick.

`OptForCausalLM.forward(..., labels=ids, training=True)` returns the
next-token cross entropy as `loss` beside `aux_loss` and, with
`output_hidden_states`, the hidden state after the embedding and after each
layer, as the JAX model does. The teacher captures come back with
`output_captures=True`: a returned capture keeps its (N, H, T, T) scores
alive through the backward (XLA drops outputs nobody reads; eager PyTorch
cannot), 2.2 GiB more for the dense OPT-125m train step at 1 x 2048. The KD
loop takes each layer's capture from the layer itself. With
`sea.layerwise`, training detaches every layer's input, as the JAX model
does. Model dims follow facebook/opt-125m. The JAX package's `scan_layers`,
`scan_benchmarking`, `scan_remat` and `external_layers` fields steer its
compiler; the port has no such fields and runs a plain layer loop. Not
ported yet: the other attention methods, decode, the chunked cross entropy,
and bfloat16 compute.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SeaConfig, opt_config
from ..ops.masks import fp_min_for
from .attention import SeaAttention, _layer_norm, init_random_, softmax_fp32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 2048
    pad_token_id: int = 1
    bos_token_id: int = 2
    do_layer_norm_before: bool = True
    dropout: float = 0.0
    attention_method: str = "perlin"  # 'none' | 'perlin'
    compute_dtype: str = "float32"
    sea: SeaConfig = dataclasses.field(default_factory=SeaConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def opt_125m(attention_method: str = "perlin", sea: Optional[SeaConfig] = None) -> OptConfig:
    return OptConfig(
        attention_method=attention_method,
        sea=sea if sea is not None else opt_config(),
    )


class LayerTeacherOutput(NamedTuple):
    """Per-layer distillation targets captured by the dense teacher."""

    attention_scores: torch.Tensor  # (N, H, T, T) pre-softmax, causal-masked
    context_layer: torch.Tensor  # (N, T, H·D) before out_proj


# one layer's resize-jitter draws (`ops.masks.resize_jitter_draws`)
JitterDraws = Tuple[torch.Tensor, torch.Tensor]


def build_causal_mask(
    attention_mask_1d: torch.Tensor, t: int, dtype=torch.float32
) -> torch.Tensor:
    """(N, T) {0,1} padding mask -> (N, 1, T, T) additive causal mask with
    FP_MIN at masked positions (0 elsewhere)."""
    fpmin = fp_min_for(dtype)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=attention_mask_1d.device))
    pad = attention_mask_1d[:, None, None, :] > 0
    alive = causal[None, None] & pad
    return torch.where(
        alive, torch.zeros((), dtype=dtype, device=alive.device),
        torch.full((), fpmin, dtype=dtype, device=alive.device),
    )


class OptAttention(nn.Module):
    """Self-attention dispatcher."""

    def __init__(self, cfg: OptConfig):
        super().__init__()
        if cfg.attention_method not in ("perlin", "none"):
            raise NotImplementedError(
                f"attention_method={cfg.attention_method!r} is not ported yet"
            )
        self.cfg = cfg
        E = cfg.hidden_size
        self.q_proj = nn.Linear(E, E)
        self.k_proj = nn.Linear(E, E)
        self.v_proj = nn.Linear(E, E)
        self.out_proj = nn.Linear(E, E)
        if cfg.attention_method == "perlin":
            self.perlin = SeaAttention(cfg.sea, device="cpu", seed=None)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        N, T, _ = x.shape
        c = self.cfg
        return x.reshape(N, T, c.num_heads, c.head_dim).permute(0, 2, 1, 3)

    def forward(
        self,
        hidden_states: torch.Tensor,
        causal_mask: torch.Tensor,
        teacher: Optional[LayerTeacherOutput] = None,
        *,
        benchmarking: bool = False,
        training: bool = False,
        jitter: Optional[JitterDraws] = None,
    ):
        """Returns (attn_output (N, T, E), aux_loss | None, teacher capture
        | None): the 'none' method captures, the student takes `teacher` as
        its KD truths and `jitter` as its resize-jitter draws."""
        c = self.cfg
        N, T, E = hidden_states.shape
        scaling = c.head_dim ** -0.5
        q = self._heads(self.q_proj(hidden_states) * scaling)
        k = self._heads(self.k_proj(hidden_states))
        v = self._heads(self.v_proj(hidden_states))

        if c.attention_method == "none":
            scores = torch.einsum("nhtd,nhsd->nhts", q, k) + causal_mask
            scores = torch.clamp(scores, min=torch.finfo(scores.dtype).min)
            probs = softmax_fp32(scores, -1)
            ctx = torch.einsum("nhts,nhsd->nhtd", probs, v)
            ctx = ctx.permute(0, 2, 1, 3).reshape(N, T, E)
            capture = LayerTeacherOutput(attention_scores=scores, context_layer=ctx)
            return self.out_proj(ctx), None, capture

        out = self.perlin(
            q, k, v, q, k, v, q, k, causal_mask,
            attention_scores_truth=teacher.attention_scores if teacher else None,
            context_layer_truth=teacher.context_layer if teacher else None,
            benchmarking=benchmarking, training=training, jitter=jitter,
        )
        return self.out_proj(out.context_layer), out.loss, None


class OptDecoderLayer(nn.Module):
    """Pre-LN decoder layer."""

    def __init__(self, cfg: OptConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = OptAttention(cfg)
        self.self_attn_layer_norm = _layer_norm(cfg.hidden_size)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.hidden_size)
        self.final_layer_norm = _layer_norm(cfg.hidden_size)

    def forward(self, hidden_states, causal_mask, teacher=None, *, benchmarking=False,
                training=False, jitter=None):
        """Returns (hidden states, aux_loss | None, teacher capture | None)."""
        c = self.cfg
        if c.sea.layerwise and training:
            # every layer optimises its own distillation loss: no gradient
            # crosses a layer boundary
            hidden_states = hidden_states.detach()
        residual = hidden_states
        h = hidden_states
        if c.do_layer_norm_before:
            h = self.self_attn_layer_norm(h)
        h, aux_loss, capture = self.self_attn(
            h, causal_mask, teacher, benchmarking=benchmarking, training=training,
            jitter=jitter,
        )
        h = F.dropout(h, c.dropout, training)
        h = residual + h
        if not c.do_layer_norm_before:
            h = self.self_attn_layer_norm(h)

        residual = h
        if c.do_layer_norm_before:
            h = self.final_layer_norm(h)
        h = self.fc2(torch.relu(self.fc1(h)))
        h = F.dropout(h, c.dropout, training)
        h = residual + h
        if not c.do_layer_norm_before:
            h = self.final_layer_norm(h)
        return h, aux_loss, capture


class OptModel(nn.Module):
    """OPT decoder stack: `embed`, the layer loop, `finalize`."""

    def __init__(self, cfg: OptConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        # OPT learned positions carry a +2 offset
        self.embed_positions = nn.Embedding(
            cfg.max_position_embeddings + 2, cfg.hidden_size
        )
        self.layers = nn.ModuleList(
            [OptDecoderLayer(cfg) for _ in range(cfg.num_layers)]
        )
        if cfg.do_layer_norm_before:
            self.final_layer_norm = _layer_norm(cfg.hidden_size)

    def embed(self, input_ids: torch.Tensor, attention_mask_1d: torch.Tensor):
        N, T = input_ids.shape
        h = self.embed_tokens(input_ids)
        positions = torch.cumsum(attention_mask_1d, dim=1) * attention_mask_1d - 1
        h = h + self.embed_positions((positions + 2).long())
        if self.cfg.attention_method == "perlin" and self.cfg.sea.use_fused_train:
            # the thin (N, 1, T, 1) dst-column mask: the fused kernels derive
            # causality themselves, and the (T, T) additive mask would cost
            # T² memory for nothing
            fpmin = fp_min_for(h.dtype)
            thin = torch.where(
                attention_mask_1d[:, None, :, None] > 0,
                torch.zeros((), dtype=h.dtype, device=h.device),
                torch.full((), fpmin, dtype=h.dtype, device=h.device),
            )
            return h, thin
        return h, build_causal_mask(attention_mask_1d, T, h.dtype)

    def finalize(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.do_layer_norm_before:
            h = self.final_layer_norm(h)
        return h

    def forward(
        self,
        input_ids,
        attention_mask_1d,
        teacher_outputs: Optional[Sequence[LayerTeacherOutput]] = None,
        *,
        benchmarking=False,
        training=False,
        jitter: Optional[Sequence[JitterDraws]] = None,
        output_hidden_states=False,
        output_captures=False,
    ):
        """Returns (final hidden states, [hidden states] | None, teacher
        captures (empty without `output_captures`), aux_loss).
        `teacher_outputs` and `jitter` hold one entry per layer."""
        h, causal_mask = self.embed(input_ids, attention_mask_1d)
        hidden_states = [h] if output_hidden_states else None
        captures: List[LayerTeacherOutput] = []
        aux_losses = []
        for i, layer in enumerate(self.layers):
            h, aux, capture = layer(
                h, causal_mask, teacher_outputs[i] if teacher_outputs is not None else None,
                benchmarking=benchmarking, training=training,
                jitter=jitter[i] if jitter is not None else None,
            )
            if output_hidden_states:
                hidden_states.append(h)
            if aux is not None:
                aux_losses.append(aux)
            if output_captures and capture is not None:
                captures.append(capture)
        h = self.finalize(h)
        aux_loss = (
            sum(aux_losses) / len(aux_losses) if aux_losses
            else torch.zeros((), device=h.device)
        )
        return h, hidden_states, captures, aux_loss


class OptForCausalLM(nn.Module):
    """LM head tied to the input embedding (OPT convention). Built on
    `device` with seeded random weights (`seed=None` leaves them
    uninitialised, for `load_state_dict`)."""

    def __init__(self, cfg: OptConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("only float32 compute is ported yet")
        self.cfg = cfg
        self.model = OptModel(cfg)
        if seed is not None:
            init_random_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.model.embed_tokens.weight.T

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask_1d: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        teacher_outputs: Optional[Sequence[LayerTeacherOutput]] = None,
        *,
        benchmarking: bool = False,
        training: bool = False,
        jitter: Optional[Sequence[JitterDraws]] = None,
        output_hidden_states: bool = False,
        output_captures: bool = False,
    ):
        h, hidden_states, captures, aux_loss = self.model(
            input_ids, attention_mask_1d, teacher_outputs, benchmarking=benchmarking,
            training=training, jitter=jitter, output_hidden_states=output_hidden_states,
            output_captures=output_captures,
        )
        logits = self.logits(h)
        loss = cross_entropy_shifted(logits, labels) if labels is not None else None
        return {"logits": logits, "loss": loss, "hidden_states": hidden_states,
                "teacher_captures": captures, "aux_loss": aux_loss}


def cross_entropy_shifted(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100
) -> torch.Tensor:
    """Next-token cross entropy with -100 masking."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe_labels = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum(), min=1)
