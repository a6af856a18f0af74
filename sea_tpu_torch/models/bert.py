"""BERT encoder with switchable attention (PyTorch port of `sea_tpu/models/bert.py`).

`attention_method` selects the self-attention of every layer:
  * 'perlin' — the non-causal SEA student (`SeaAttention`): on the fused
    benchmark path (`benchmarking=True`) kernel K5, the padded
    bidirectional fused sparse attention, once per layer; otherwise the
    dense train path, which takes the teacher's `LayerTeacherOutput` as its
    KD truths (`training=True`: the GLUE and LRA trainers' student);
  * 'none' — dense softmax attention over the unpadded keys: the KD
    teacher, whose layers return their captures (the scaled, masked scores
    and the context before the output projection), and the yardstick;
  * the baselines 'performer' (non-causal FAVOR+ softmax features on the
    layer's `performer_proj`, padded value rows zeroed), 'synthesizer'
    (`SynthesizerDense`), 'cosformer' (the non-causal `CosformerAttention`
    on the padded-zeroed hidden states, its own projections), 'reformer'
    (LSH attention, padding hashed to a bucket of its own), 'scatterbrain'
    (FAVOR+ plus LSH-chunk corrections) and 'sinkhorn' (block Sinkhorn,
    padded keys masked), with the JAX package's bucket and block sizes.
    Their random rotations are JAX's fixed `key(0)`'s counterpart
    (`ops.baselines.lsh_rotations`, seed 0), the same every call.

Post-LN layers (LayerNorm epsilon 1e-12), GELU FFN, learned absolute
positions, token-type embeddings, a tanh pooler over the first token.
`remat_layers` runs each layer under a non-reentrant
`torch.utils.checkpoint` while grad is on (no layer draws anything: the
non-causal SEA path takes no jitter, and the rotations are fixed).
`token_merging` wraps each layer's FFN in ToMe's merge and unmerge
(`ops/tome.py`), scored by the keys' similarity ('key') or by the layer's
head-mean attention probabilities ('probs': the dense train path's
`partial_attention_probs`, or the dense teacher's).

Heads: `BertForSequenceClassification` (cross entropy or, with one label,
MSE), `BertForQuestionAnswering`, `BertForTokenClassification`,
`BertForMultipleChoice` and `BertForMaskedLM` (the decoder tied to the
word embeddings). Each returns the JAX head's dict, with the hidden states
(`output_hidden_states`) and the teacher captures. Batches are
right-padded: `attention_mask_1d` (N, T) is 1 on the tokens. Attribute names
follow the JAX modules, so that `weights.state_dict_from_jax` maps their
variables unchanged.

Not ported yet, and refused with NotImplementedError: LoRA (ROADMAP queue 1
item 4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SeaConfig, bert_config
from ..ops.baselines import (SynthesizerDense, reformer_lsh_attention, scatterbrain_attention,
                             sinkhorn_block_attention)
from ..ops.cosformer import CosformerAttention
from ..ops.masks import fp_min_for
from ..ops.performer import fast_attention
from ..ops.tome import tome_merge, tome_unmerge
from .attention import SeaAttention, init_random_, softmax_fp32
from .opt import LayerTeacherOutput

METHODS = ("perlin", "none", "performer", "synthesizer", "cosformer", "reformer",
           "scatterbrain", "sinkhorn")


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
    attention_method: str = "perlin"  # one of METHODS
    # each encoder layer under a checkpoint in training
    remat_layers: bool = False
    # ToMe token merging around the FFN
    token_merging: bool = False
    token_merging_preserve_ratio: float = 0.5
    token_merging_ratio: float = 0.5
    token_merging_score_source: str = "key"  # 'key' | 'probs'
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


def _block(k: int, t: int, floor: int = 1) -> int:
    """The JAX package's bucket or block size for length t: max(k, floor)
    clamped to [1, t // 2], then lowered until it divides t."""
    bs = max(min(max(k, floor), t // 2), 1)
    while t % bs:
        bs -= 1
    return bs


class BertSelfAttention(nn.Module):
    """Attention dispatcher: q, k, v projections, then SEA, dense or a
    baseline."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        if cfg.attention_method not in METHODS:
            raise ValueError(f"attention_method {cfg.attention_method!r}")
        if cfg.attention_method == "perlin" and (
                cfg.sea.lora_enabled or cfg.sea.lora_in_approx_enabled):
            raise NotImplementedError("LoRA is not ported yet (ROADMAP queue 1 item 4)")
        self.cfg = cfg
        E = cfg.hidden_size
        self.query = nn.Linear(E, E)
        self.key = nn.Linear(E, E)
        self.value = nn.Linear(E, E)
        method = cfg.attention_method
        if method == "perlin":
            self.perlin = SeaAttention(cfg.sea, device="cpu", seed=None)
        elif method in ("performer", "scatterbrain"):
            self.register_buffer("performer_proj", torch.empty(cfg.sea.nb_features, cfg.head_dim))
        elif method == "synthesizer":
            self.synthesizer = SynthesizerDense(cfg.head_dim, cfg.max_position_embeddings)
        elif method == "cosformer":
            self.cosformer = CosformerAttention(E, cfg.num_heads, has_outproj=False,
                                                causal=False, device="cpu")

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        N, T, _ = x.shape
        c = self.cfg
        return x.reshape(N, T, c.num_heads, c.head_dim).permute(0, 2, 1, 3)

    def forward(self, hidden_states, attention_mask, teacher=None, *, benchmarking=False,
                training=False):
        """attention_mask: (N, 1, 1, T) additive. Returns (context (N, T, E),
        aux_loss | None, teacher capture | None, merge similarity (N, T, T)
        | None)."""
        c = self.cfg
        method = c.attention_method
        N, T, E = hidden_states.shape
        q = self._heads(self.query(hidden_states))
        k = self._heads(self.key(hidden_states))
        v = self._heads(self.value(hidden_states))

        merge_sim = None
        if c.token_merging:
            if c.token_merging_score_source == "key":
                merge_sim = torch.einsum("nhtd,nhsd->nts", k, k) / c.num_heads
            elif c.token_merging_score_source != "probs":
                raise ValueError(c.token_merging_score_source)
        from_probs = c.token_merging and c.token_merging_score_source == "probs"

        def merged(ctx):  # (N, H, T, D) -> (N, T, E)
            return ctx.permute(0, 2, 1, 3).reshape(N, T, E)

        alive = attention_mask > -1  # (N, 1, 1, T)
        mask_1d = alive[:, 0, 0, :]
        if method == "none":
            scores = torch.einsum("nhtd,nhsd->nhts", q, k) / math.sqrt(c.head_dim)
            scores = scores + attention_mask
            probs = softmax_fp32(scores, -1)
            if from_probs:
                merge_sim = probs.float().mean(1)
            ctx = merged(torch.einsum("nhts,nhsd->nhtd", probs, v))
            return ctx, None, LayerTeacherOutput(scores, ctx), merge_sim
        if method == "perlin":
            out = self.perlin(
                q, k, v, q, k, v, q, k, attention_mask,
                attention_scores_truth=teacher.attention_scores if teacher else None,
                context_layer_truth=teacher.context_layer if teacher else None,
                benchmarking=benchmarking, training=training,
            )
            if from_probs:
                if benchmarking or out.partial_attention_probs is None:
                    raise ValueError(
                        "the 'probs' merge score needs the train path's attention "
                        "probabilities, which the fused benchmark path never builds")
                merge_sim = out.partial_attention_probs.float().mean(1)
            return out.context_layer, out.loss, None, merge_sim

        if method == "performer":
            dst_alive = alive.transpose(-1, -2)  # (N, 1, T, 1)
            out = fast_attention(q.float(), k.float(), (v * dst_alive).float(),
                                 self.performer_proj, causal=False, generalized=False)
            ctx = merged(out.to(hidden_states.dtype))
        elif method == "synthesizer":
            ctx = merged(self.synthesizer(q, v, mask=alive)[0])
        elif method == "cosformer":
            h = hidden_states * alive[:, 0].transpose(-1, -2).to(hidden_states.dtype)
            ctx = self.cosformer(h.transpose(0, 1)).transpose(0, 1)
        elif method == "reformer":
            ctx = merged(reformer_lsh_attention(
                q, v, bucket_size=_block(c.sea.k, T, 8), n_hashes=4, causal=False,
                mask_1d=mask_1d))
        elif method == "scatterbrain":
            ctx = merged(scatterbrain_attention(q, k, v, self.performer_proj,
                                                bucket_size=_block(c.sea.k, T, 8)))
        else:
            ctx = merged(sinkhorn_block_attention(q, k, v, block_size=_block(c.sea.k, T),
                                                  mask_1d=mask_1d))
        return ctx, None, None, merge_sim


class BertLayer(nn.Module):
    """Post-LN encoder layer, the FFN optionally inside ToMe."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        E, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg)
        self.attention_output = nn.Linear(E, E)
        self.attention_ln = nn.LayerNorm(E, eps=eps)
        self.intermediate = nn.Linear(E, cfg.ffn_dim)
        self.output = nn.Linear(cfg.ffn_dim, E)
        self.output_ln = nn.LayerNorm(E, eps=eps)

    def forward(self, h, attention_mask, teacher=None, *, benchmarking=False, training=False):
        """Returns (hidden states, aux_loss | None, teacher capture | None)."""
        ctx, aux, capture, merge_sim = self.attention(
            h, attention_mask, teacher, benchmarking=benchmarking, training=training)
        h = self.attention_ln(h + self.attention_output(ctx))
        if self.cfg.token_merging and merge_sim is not None:
            c = self.cfg
            h_merged, state = tome_merge(h, merge_sim, c.token_merging_preserve_ratio,
                                         c.token_merging_ratio)
            ffn = self.output(F.gelu(self.intermediate(h_merged), approximate="none"))
            h = tome_unmerge(self.output_ln(h_merged + ffn), state)
        else:
            ffn = self.output(F.gelu(self.intermediate(h), approximate="none"))
            h = self.output_ln(h + ffn)
        return h, aux, capture


class BertModel(nn.Module):
    """Embeddings, the encoder stack and the pooler."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
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

    def forward(self, input_ids, attention_mask_1d, token_type_ids=None,
                teacher_outputs: Optional[List[LayerTeacherOutput]] = None, *,
                benchmarking=False, training=False, output_hidden_states=False):
        """Returns (last hidden state (N, T, E), pooled (N, E), [hidden
        states] | None, teacher captures, aux_loss)."""
        h, mask = self.embed(input_ids, attention_mask_1d, token_type_ids)
        hidden_states = [h] if output_hidden_states else None
        captures, aux_losses = [], []
        remat = self.cfg.remat_layers and torch.is_grad_enabled()
        if remat and h.is_cuda and torch.backends.cudnn.benchmark:
            raise RuntimeError(
                "remat_layers with torch.backends.cudnn.benchmark on: the recompute could "
                "choose another convolution algorithm and so another top-k mask")
        for i, layer in enumerate(self.layers):
            teacher = teacher_outputs[i] if teacher_outputs is not None else None
            kw = dict(benchmarking=benchmarking, training=training)
            if remat:
                h, aux, capture = checkpoint(layer, h, mask, teacher, use_reentrant=False, **kw)
            else:
                h, aux, capture = layer(h, mask, teacher, **kw)
            if output_hidden_states:
                hidden_states.append(h)
            if aux is not None:
                aux_losses.append(aux)
            if capture is not None:
                captures.append(capture)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        aux_loss = (
            sum(aux_losses) / len(aux_losses) if aux_losses
            else torch.zeros((), device=h.device)
        )
        return h, pooled, hidden_states, captures, aux_loss


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not -100."""
    logp = torch.log_softmax(logits.float(), -1)
    alive = labels != -100
    safe = torch.where(alive, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * alive).sum() / torch.clamp(alive.sum(), min=1)


def _outputs(h, hidden_states, captures, aux_loss, **heads) -> Dict[str, object]:
    return {**heads, "hidden_states": hidden_states, "teacher_captures": captures,
            "aux_loss": aux_loss, "last_hidden_state": h}


class _BertHead(nn.Module):
    """An encoder and a head. Built on `device` with seeded random weights
    (`seed=None` leaves them uninitialised, for `load_state_dict`)."""

    def _finish(self, device, seed: Optional[int]):
        if seed is not None:
            init_random_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def _encode(self, input_ids, attention_mask_1d, token_type_ids, teacher_outputs,
                benchmarking, training, output_hidden_states):
        return self.bert(input_ids, attention_mask_1d, token_type_ids, teacher_outputs,
                         benchmarking=benchmarking, training=training,
                         output_hidden_states=output_hidden_states)


class BertForSequenceClassification(_BertHead):
    """Classifier over the pooled first token."""

    def __init__(self, cfg: BertConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)
        self._finish(device, seed)

    def forward(self, input_ids, attention_mask_1d, token_type_ids=None, labels=None,
                teacher_outputs=None, *, benchmarking=False, training=False,
                output_hidden_states=False):
        h, pooled, hidden_states, captures, aux_loss = self._encode(
            input_ids, attention_mask_1d, token_type_ids, teacher_outputs, benchmarking,
            training, output_hidden_states)
        logits = self.classifier(pooled)
        loss = None
        if labels is not None:
            if self.cfg.num_labels == 1:
                loss = torch.mean((logits[..., 0] - labels) ** 2)
            else:
                logp = torch.log_softmax(logits.float(), -1)
                loss = -torch.gather(logp, -1, labels[:, None].long()).mean()
        return _outputs(h, hidden_states, captures, aux_loss, logits=logits, loss=loss)


class BertForQuestionAnswering(_BertHead):
    """Extractive QA: start and end logits from a 2-unit dense over the
    sequence; the loss is the mean of the two cross entropies, positions
    clamped to [0, T] and T ignored (no answer in the span)."""

    def __init__(self, cfg: BertConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.qa_outputs = nn.Linear(cfg.hidden_size, 2)
        self._finish(device, seed)

    def forward(self, input_ids, attention_mask_1d, token_type_ids=None, start_positions=None,
                end_positions=None, teacher_outputs=None, *, benchmarking=False,
                training=False, output_hidden_states=False):
        h, _, hidden_states, captures, aux_loss = self._encode(
            input_ids, attention_mask_1d, token_type_ids, teacher_outputs, benchmarking,
            training, output_hidden_states)
        logits = self.qa_outputs(h)
        start_logits, end_logits = logits[..., 0], logits[..., 1]
        loss = None
        if start_positions is not None and end_positions is not None:
            T = start_logits.shape[1]

            def span_ce(lg, pos):
                pos = torch.clamp(pos, 0, T)
                return _masked_nll(lg, torch.where(pos != T, pos, torch.full_like(pos, -100)))

            loss = 0.5 * (span_ce(start_logits, start_positions)
                          + span_ce(end_logits, end_positions))
        return _outputs(h, hidden_states, captures, aux_loss, start_logits=start_logits,
                        end_logits=end_logits, loss=loss)


class BertForTokenClassification(_BertHead):
    """A classifier over every position; cross entropy where the label is
    not -100."""

    def __init__(self, cfg: BertConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)
        self._finish(device, seed)

    def forward(self, input_ids, attention_mask_1d, token_type_ids=None, labels=None,
                teacher_outputs=None, *, benchmarking=False, training=False,
                output_hidden_states=False):
        h, _, hidden_states, captures, aux_loss = self._encode(
            input_ids, attention_mask_1d, token_type_ids, teacher_outputs, benchmarking,
            training, output_hidden_states)
        logits = self.classifier(h)
        loss = _masked_nll(logits, labels) if labels is not None else None
        return _outputs(h, hidden_states, captures, aux_loss, logits=logits, loss=loss)


class BertForMultipleChoice(_BertHead):
    """Inputs (N, C, T): the choices flattened into the batch, each pooled
    and scored by a 1-unit dense, the C scores softmaxed against the gold
    choice."""

    def __init__(self, cfg: BertConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, 1)
        self._finish(device, seed)

    def forward(self, input_ids, attention_mask_1d, token_type_ids=None, labels=None,
                teacher_outputs=None, *, benchmarking=False, training=False,
                output_hidden_states=False):
        N, C, T = input_ids.shape
        flat_types = token_type_ids.reshape(N * C, T) if token_type_ids is not None else None
        h, pooled, hidden_states, captures, aux_loss = self._encode(
            input_ids.reshape(N * C, T), attention_mask_1d.reshape(N * C, T), flat_types,
            teacher_outputs, benchmarking, training, output_hidden_states)
        logits = self.classifier(pooled).reshape(N, C)
        loss = None
        if labels is not None:
            logp = torch.log_softmax(logits.float(), -1)
            loss = -torch.gather(logp, -1, labels[:, None].long()).mean()
        return _outputs(h, hidden_states, captures, aux_loss, logits=logits, loss=loss)


class BertForMaskedLM(_BertHead):
    """MLM head: dense, tanh-approximated GELU (flax's default) and
    LayerNorm, then a decoder tied to the word embeddings plus a free bias;
    cross entropy where the label is not -100."""

    def __init__(self, cfg: BertConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self._finish(device, seed)

    def forward(self, input_ids, attention_mask_1d, token_type_ids=None, labels=None,
                teacher_outputs=None, *, benchmarking=False, training=False,
                output_hidden_states=False):
        h, _, hidden_states, captures, aux_loss = self._encode(
            input_ids, attention_mask_1d, token_type_ids, teacher_outputs, benchmarking,
            training, output_hidden_states)
        t = self.transform_ln(F.gelu(self.transform(h), approximate="tanh"))
        logits = t @ self.bert.word_embeddings.weight.T + self.decoder_bias
        loss = _masked_nll(logits, labels) if labels is not None else None
        return _outputs(h, hidden_states, captures, aux_loss, logits=logits, loss=loss)
