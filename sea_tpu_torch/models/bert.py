"""BERT encoder with switchable attention (PyTorch port of `sea_tpu/models/bert.py`).

`attention_method` selects the self-attention of every layer:
  * 'perlin' — the non-causal SEA student (`SeaAttention`) on the fused
    benchmark path (`benchmarking=True`): kernel K5, the padded
    bidirectional fused sparse attention, once per layer;
  * 'none'   — dense softmax attention over the unpadded keys, the in-repo
    yardstick and the teacher of the KD path.

Post-LN layers (LayerNorm epsilon 1e-12), GELU FFN, learned absolute
positions, token-type embeddings, a tanh pooler over the first token and a
classifier (`BertForSequenceClassification`, cross entropy or, with one
label, MSE). Batches are right-padded: `attention_mask_1d` (N, T) is 1 on the
tokens and 0 on the padding. Attribute names follow the JAX modules, so that
`weights.state_dict_from_jax` maps their variables unchanged.

Not ported yet, and refused with NotImplementedError: the other attention
methods (performer, synthesizer, cosformer, reformer, scatterbrain,
sinkhorn), the SEA student's train paths and KD captures, token merging,
`remat_layers`, LoRA, and the other heads (question answering, token
classification, multiple choice, masked LM).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SeaConfig, bert_config
from ..ops.masks import fp_min_for
from .attention import SeaAttention, init_random_, softmax_fp32


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    layer_norm_eps: float = 1e-12
    attention_method: str = "perlin"  # 'none' | 'perlin'
    remat_layers: bool = False  # refused: not ported
    token_merging: bool = False  # refused: ToMe is not ported
    sea: SeaConfig = dataclasses.field(default_factory=SeaConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_base(attention_method: str = "perlin", sea: Optional[SeaConfig] = None, **kw) -> BertConfig:
    """bert-base-uncased widths with the canonical non-causal SEA config."""
    return BertConfig(
        attention_method=attention_method,
        sea=sea if sea is not None else bert_config(),
        **kw,
    )


class BertSelfAttention(nn.Module):
    """Attention dispatcher: q, k, v projections, then SEA or dense."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        if cfg.attention_method not in ("perlin", "none"):
            raise NotImplementedError(
                f"attention_method={cfg.attention_method!r} is not ported yet"
            )
        self.cfg = cfg
        E = cfg.hidden_size
        self.query = nn.Linear(E, E)
        self.key = nn.Linear(E, E)
        self.value = nn.Linear(E, E)
        if cfg.attention_method == "perlin":
            self.perlin = SeaAttention(cfg.sea, device="cpu", seed=None)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        N, T, _ = x.shape
        c = self.cfg
        return x.reshape(N, T, c.num_heads, c.head_dim).permute(0, 2, 1, 3)

    def forward(self, hidden_states, attention_mask, *, benchmarking=False):
        """attention_mask: (N, 1, 1, T) additive. Returns (context (N, T, E),
        aux_loss | None)."""
        c = self.cfg
        N, T, E = hidden_states.shape
        q = self._heads(self.query(hidden_states))
        k = self._heads(self.key(hidden_states))
        v = self._heads(self.value(hidden_states))
        if c.attention_method == "none":
            scores = torch.einsum("nhtd,nhsd->nhts", q, k) / math.sqrt(c.head_dim)
            probs = softmax_fp32(scores + attention_mask, -1)
            ctx = torch.einsum("nhts,nhsd->nhtd", probs, v)
            return ctx.permute(0, 2, 1, 3).reshape(N, T, E), None
        if not benchmarking:
            raise NotImplementedError(
                "BERT's SEA train path is not ported yet (ROADMAP queue 1, "
                "'BERT and LRA training')"
            )
        out = self.perlin(q, k, v, q, k, v, q, k, attention_mask, benchmarking=True)
        return out.context_layer, out.loss


class BertLayer(nn.Module):
    """Post-LN encoder layer."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        E, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg)
        self.attention_output = nn.Linear(E, E)
        self.attention_ln = nn.LayerNorm(E, eps=eps)
        self.intermediate = nn.Linear(E, cfg.ffn_dim)
        self.output = nn.Linear(cfg.ffn_dim, E)
        self.output_ln = nn.LayerNorm(E, eps=eps)

    def forward(self, h, attention_mask, *, benchmarking=False):
        ctx, aux = self.attention(h, attention_mask, benchmarking=benchmarking)
        h = self.attention_ln(h + self.attention_output(ctx))
        ffn = self.output(F.gelu(self.intermediate(h), approximate="none"))
        return self.output_ln(h + ffn), aux


class BertModel(nn.Module):
    """Embeddings, the encoder stack and the pooler."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        if cfg.token_merging or cfg.remat_layers:
            raise NotImplementedError("token merging and remat_layers are not ported yet")
        self.cfg = cfg
        E = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, E)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, E)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, E)
        self.embeddings_ln = nn.LayerNorm(E, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(E, E)

    def embed(self, input_ids, attention_mask_1d, token_type_ids=None):
        """Token + position + token-type embeddings through LayerNorm, and the
        (N, 1, 1, T) additive mask: 0 on tokens, FP_MIN on padding."""
        N, T = input_ids.shape
        pos = torch.arange(T, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos)
            + self.token_type_embeddings(token_type_ids)
        )
        h = self.embeddings_ln(h)
        mask = torch.where(
            attention_mask_1d[:, None, None, :] > 0,
            torch.zeros((), dtype=h.dtype, device=h.device),
            torch.full((), fp_min_for(h.dtype), dtype=h.dtype, device=h.device),
        )
        return h, mask

    def forward(self, input_ids, attention_mask_1d, token_type_ids=None, *,
                benchmarking=False):
        """Returns (last hidden state (N, T, E), pooled (N, E), aux_loss)."""
        h, mask = self.embed(input_ids, attention_mask_1d, token_type_ids)
        aux_losses = []
        for layer in self.layers:
            h, aux = layer(h, mask, benchmarking=benchmarking)
            if aux is not None:
                aux_losses.append(aux)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        aux_loss = (
            sum(aux_losses) / len(aux_losses) if aux_losses
            else torch.zeros((), device=h.device)
        )
        return h, pooled, aux_loss


class BertForSequenceClassification(nn.Module):
    """Classifier over the pooled first token. Built on `device` with seeded
    random weights (`seed=None` leaves them uninitialised, for
    `load_state_dict`)."""

    def __init__(self, cfg: BertConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)
        if seed is not None:
            init_random_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask_1d: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        *,
        benchmarking: bool = False,
    ):
        h, pooled, aux_loss = self.bert(
            input_ids, attention_mask_1d, token_type_ids, benchmarking=benchmarking,
        )
        logits = self.classifier(pooled)
        loss = None
        if labels is not None:
            if self.cfg.num_labels == 1:
                loss = torch.mean((logits[..., 0] - labels) ** 2)
            else:
                logp = torch.log_softmax(logits.float(), -1)
                loss = -torch.gather(logp, -1, labels[:, None].long()).mean()
        return {"logits": logits, "loss": loss, "aux_loss": aux_loss,
                "last_hidden_state": h}
