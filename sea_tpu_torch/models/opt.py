"""OPT decoder with switchable attention (PyTorch port of `sea_tpu/models/opt.py`).

`attention_method` selects the self-attention of every layer:
  * 'perlin' — the SEA student (`SeaAttention`), forward on the fused
    benchmark path (`benchmarking=True`);
  * 'none'   — dense causal softmax attention, the in-repo yardstick.

Model dims follow facebook/opt-125m. The JAX package's `scan_layers`,
`scan_benchmarking`, `scan_remat` and `external_layers` fields steer its
compiler; the port has no such fields and runs a plain layer loop. Not
ported yet: the other attention methods, KD captures, decode, and bfloat16
compute.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
        *,
        benchmarking: bool = False,
        training: bool = False,
    ):
        """Returns (attn_output (N, T, E), aux_loss | None)."""
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
            return self.out_proj(ctx), None

        out = self.perlin(
            q, k, v, q, k, v, q, k, causal_mask,
            benchmarking=benchmarking, training=training,
        )
        return self.out_proj(out.context_layer), out.loss


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

    def forward(self, hidden_states, causal_mask, *, benchmarking=False, training=False):
        c = self.cfg
        residual = hidden_states
        h = hidden_states
        if c.do_layer_norm_before:
            h = self.self_attn_layer_norm(h)
        h, aux_loss = self.self_attn(
            h, causal_mask, benchmarking=benchmarking, training=training
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
        return h, aux_loss


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
        return h, build_causal_mask(attention_mask_1d, T, h.dtype)

    def finalize(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.do_layer_norm_before:
            h = self.final_layer_norm(h)
        return h

    def forward(self, input_ids, attention_mask_1d, *, benchmarking=False, training=False):
        h, causal_mask = self.embed(input_ids, attention_mask_1d)
        aux_losses = []
        for layer in self.layers:
            h, aux = layer(h, causal_mask, benchmarking=benchmarking, training=training)
            if aux is not None:
                aux_losses.append(aux)
        h = self.finalize(h)
        aux_loss = (
            sum(aux_losses) / len(aux_losses) if aux_losses
            else torch.zeros((), device=h.device)
        )
        return h, aux_loss


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
        *,
        benchmarking: bool = False,
        training: bool = False,
    ):
        h, aux_loss = self.model(
            input_ids, attention_mask_1d, benchmarking=benchmarking, training=training
        )
        logits = self.logits(h)
        loss = cross_entropy_shifted(logits, labels) if labels is not None else None
        return {"logits": logits, "loss": loss, "aux_loss": aux_loss}


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
