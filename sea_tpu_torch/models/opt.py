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
does. Model dims follow facebook/opt-125m.

The long-context memory plan (the JAX package's, field for field):
`scan_layers` runs the stack as JAX's scanned body runs it (`scan_layers`
below): every layer is called with `benchmarking=cfg.scan_benchmarking` and
neither `training` nor jitter, whatever the caller passes, and `aux_loss` is
the mean of the per-layer aux values (0.0 where a layer has none); the
scanned forward takes no KD truths and returns no hidden states. The model
keeps its `nn.ModuleList` and its `state_dict` (eager PyTorch has no
compiled graph for a scan to shrink; `weights.py` reads JAX's stacked
`layers_scan` trees into it). `scan_remat` runs each layer under
`torch.utils.checkpoint` while grad is enabled: the backward keeps each
layer's inputs and recomputes the rest, so one layer's activations are
live at a time, and the recompute launches the layer's forward kernels
again (K2 twice a layer a step under `use_fused_train`, as JAX's `nn.remat`
does). `forward(..., labels=, logit_chunk=C)` returns the next-token cross
entropy computed per chunk of the sequence under a checkpoint each
(`chunked_cross_entropy_shifted`), so one (N, C, V) logits block is live,
and returns `logits=None`.

Decode and generation (the SEA student with `sea.use_cache`): per-layer
`SeaDecodeState`s (`init_decode_states`), the prompt ingested by P decode
steps or one batched forward (`prefill_parallel`, whose attention output is
the benchmark path's, kernel K1), `decode_step` against contiguous caches and
`decode_step_paged` against the serving engine's paged pools, and the loops
`generate_greedy`, `generate_sample` and `generate_beam` (Python loops where
JAX has `lax.scan`; nothing is read back to the host inside them).

Types follow the JAX model exactly. `compute_dtype` ("float32" or
"bfloat16") is the type `embed` casts the embedding to, and the type each
layer's output is cast back to in `forward`; inside a layer every `Dense`
and `LayerNorm` computes in the promoted type of its input and parameters
(flax's rule, `modules.Dense`). So with float32 parameters a bfloat16
`compute_dtype` rounds only the embedding and the layer outputs, and every
projection, the SEA attention and its kernels run float32; bfloat16
parameters (the model cast as a whole, `model.to(torch.bfloat16)`, as the
JAX scripts and the trainer's `param_dtype` cast the tree) run them in
bfloat16 (kernels K1-K4's bf16 instances). Decode never casts: `decode_step`
and `decode_step_paged` embed in the parameters' type, and the layers'
`decode`, `prefill` and `decode_paged` keep the promoted type; only
`prefill_parallel` rounds its embedding, through `embed`. The builders
`opt_350m`, `opt_1_3b` and `opt_2_7b` are the JAX package's (1.3b and 2.7b
in bfloat16 compute; 2.7b's heads are 80 wide, which K1-K4 take).

`scan_decode_step`, `scan_prefill_parallel` and `scan_generate_greedy` are
the JAX package's scanned decode helpers: they drive the loop decode and take
and return the per-layer decode states stacked on axis 0, in JAX's layout.

The baseline students 'performer' (causal generalised FAVOR+ on the
layer's own `performer_proj` buffer), 'reformer' (LSH attention; the
rotations are the layer's draws, JAX's `rng`: passed in through `jitter`
or, without them, drawn from a generator seeded 7 as JAX falls back on
`key(7)`), 'sinkhorn' (causal sparse Sinkhorn, blocks of `sea.k`) and
'cosformer' (the causal `CosformerAttention` with its own projections) run
`causal_baseline_context` (`ops/baselines.py`, plain PyTorch, float32
islands), their padded value rows zeroed; they carry no KD loss and no
capture. Decode is the SEA student's alone, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SeaConfig, opt_config
from ..ops.baselines import (lsh_buckets, lsh_rotations, reformer_lsh_attention,
                             sinkhorn_causal_attention)
from ..ops.cosformer import CosformerAttention
from ..ops.masks import fp_min_for
from ..ops.performer import fast_attention
from ..ops.sampling import sample_logits
from .attention import SeaAttention, _layer_norm, init_random_, softmax_fp32
from .modules import Dense, promote
from .state import SeaDecodeState

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    # the scanned layer stack (see the module doc): its mode of every layer
    # (False: the train paths, True: the fused benchmark path) and the
    # per-layer rematerialisation under grad
    scan_layers: bool = False
    scan_benchmarking: bool = False
    scan_remat: bool = False
    sea: SeaConfig = dataclasses.field(default_factory=SeaConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def opt_125m(attention_method: str = "perlin", sea: Optional[SeaConfig] = None) -> OptConfig:
    return OptConfig(
        attention_method=attention_method,
        sea=sea if sea is not None else opt_config(),
    )


def opt_350m(attention_method: str = "perlin", sea: Optional[SeaConfig] = None) -> OptConfig:
    return OptConfig(
        hidden_size=1024,
        num_layers=24,
        num_heads=16,
        ffn_dim=4096,
        attention_method=attention_method,
        sea=sea if sea is not None else opt_config(num_heads=16, head_dim=64),
    )


def opt_1_3b(attention_method: str = "perlin", sea: Optional[SeaConfig] = None) -> OptConfig:
    """facebook/opt-1.3b's geometry, in bfloat16 compute."""
    return OptConfig(
        hidden_size=2048,
        num_layers=24,
        num_heads=32,
        ffn_dim=8192,
        attention_method=attention_method,
        compute_dtype="bfloat16",
        sea=sea if sea is not None else opt_config(num_heads=32, head_dim=64),
    )


def opt_2_7b(attention_method: str = "perlin", sea: Optional[SeaConfig] = None) -> OptConfig:
    """facebook/opt-2.7b's geometry (heads of width 80), in bfloat16
    compute."""
    return OptConfig(
        hidden_size=2560,
        num_layers=32,
        num_heads=32,
        ffn_dim=10240,
        attention_method=attention_method,
        compute_dtype="bfloat16",
        sea=sea if sea is not None else opt_config(num_heads=32, head_dim=80),
    )


class LayerTeacherOutput(NamedTuple):
    """Per-layer distillation targets captured by the dense teacher."""

    attention_scores: torch.Tensor  # (N, H, T, T) pre-softmax, causal-masked
    context_layer: torch.Tensor  # (N, T, H·D) before out_proj


# one layer's random draws, JAX's per-layer `rng`: a 'perlin' student's
# resize jitter (`ops.masks.resize_jitter_draws`), or a 'reformer' student's
# LSH rotations (`reformer_draws`)
JitterDraws = Union[Tuple[torch.Tensor, torch.Tensor], List[torch.Tensor]]

# the causal baseline students, and the reformer's fallback seed (JAX's
# `key(7)` when no rng is given)
BASELINE_METHODS = ("performer", "reformer", "sinkhorn", "cosformer")
REFORMER_SEED = 7
REFORMER_BUCKET, REFORMER_HASHES = 64, 4


def add_causal_baseline(attn: nn.Module, method: str, hidden_size: int, num_heads: int,
                        sea: SeaConfig) -> None:
    """Give a decoder's attention module what its baseline student keeps:
    the performer's FAVOR+ projection (a buffer, as SEA's) or the
    cosformer's projections; the reformer and sinkhorn learn nothing."""
    if method == "performer":
        attn.register_buffer("performer_proj", torch.empty(sea.nb_features, sea.head_dim))
    elif method == "cosformer":
        attn.cosformer = CosformerAttention(hidden_size, num_heads, has_outproj=False,
                                            causal=True, device="cpu")


def reformer_draws(head_dim: int, t: int, generator: Optional[torch.Generator] = None,
                   device="cpu") -> List[torch.Tensor]:
    """One reformer layer's rotations at length `t` (`REFORMER_HASHES` of
    (head_dim, n_buckets / 2)), from `generator` (None: seed
    `REFORMER_SEED`'s)."""
    _, n_buckets = lsh_buckets(t, REFORMER_BUCKET)
    return lsh_rotations(head_dim, n_buckets, REFORMER_HASHES, generator,
                         seed=REFORMER_SEED, device=device)


def causal_baseline_context(attn: nn.Module, method: str, q, k, v, causal_mask,
                            k_cfg: int, dtype: torch.dtype,
                            draws: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The (N, T, H·D) context of a causal baseline student (OPT's and
    LLaMA's alike, `sea_tpu/models/opt.py:246-294`) from its heads q, k, v
    (N, H, T, D; q scaled), in `dtype`; each method computes in float32."""
    N, H, T, D = q.shape
    if method == "performer":
        out = fast_attention(q.float(), k.float(), v.float(), attn.performer_proj,
                             causal=True, generalized=True)
        return out.to(dtype).permute(0, 2, 1, 3).reshape(N, T, H * D)
    # padded value rows zeroed, as the reference's v * (mask[..., :1] > -1)
    v = torch.where(causal_mask[:, :, :, :1] > -1, v, torch.zeros((), dtype=v.dtype,
                                                                    device=v.device))
    if method == "cosformer":
        def to_seq(x):  # (N, H, T, D) -> (T, N, H·D), float32
            return x.permute(0, 2, 1, 3).reshape(N, T, H * D).transpose(0, 1).float()

        return attn.cosformer(to_seq(q), to_seq(k), to_seq(v)).transpose(0, 1).to(dtype)
    if method == "reformer":
        if draws is None:
            draws = reformer_draws(D, T, device=q.device)
        out = reformer_lsh_attention(q.float(), v.float(), bucket_size=REFORMER_BUCKET,
                                     n_hashes=REFORMER_HASHES, causal=True, rotations=draws)
    elif method == "sinkhorn":
        out = sinkhorn_causal_attention(q.float(), k.float(), v.float(),
                                        block_size=min(k_cfg, T))
    else:
        raise ValueError(f"attention_method {method!r}")
    return out.to(dtype).permute(0, 2, 1, 3).reshape(N, T, H * D)


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
        if cfg.attention_method not in ("perlin", "none", *BASELINE_METHODS):
            raise ValueError(f"attention_method {cfg.attention_method!r}")
        self.cfg = cfg
        E = cfg.hidden_size
        self.q_proj = Dense(E, E)
        self.k_proj = Dense(E, E)
        self.v_proj = Dense(E, E)
        self.out_proj = Dense(E, E)
        if cfg.attention_method == "perlin":
            self.perlin = SeaAttention(cfg.sea, device="cpu", seed=None)
        elif cfg.attention_method != "none":
            add_causal_baseline(self, cfg.attention_method, E, cfg.num_heads, cfg.sea)

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
        | None): the 'none' method captures, the SEA student takes `teacher`
        as its KD truths and `jitter` as its resize-jitter draws, a reformer
        student `jitter` as its rotations."""
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
        if c.attention_method != "perlin":
            ctx = causal_baseline_context(self, c.attention_method, q, k, v, causal_mask,
                                          c.sea.k, hidden_states.dtype, jitter)
            return self.out_proj(ctx), None, None

        out = self.perlin(
            q, k, v, q, k, v, q, k, causal_mask,
            attention_scores_truth=teacher.attention_scores if teacher else None,
            context_layer_truth=teacher.context_layer if teacher else None,
            benchmarking=benchmarking, training=training, jitter=jitter,
        )
        return self.out_proj(out.context_layer), out.loss, None

    def _qkv(self, hidden_states: torch.Tensor):
        if self.cfg.attention_method != "perlin":
            raise NotImplementedError("decode is ported for the SEA student ('perlin') only")
        scaling = self.cfg.head_dim ** -0.5
        return (self._heads(self.q_proj(hidden_states) * scaling),
                self._heads(self.k_proj(hidden_states)),
                self._heads(self.v_proj(hidden_states)))

    def init_state(self, batch: int, max_len: int, dtype=torch.float32) -> SeaDecodeState:
        if self.cfg.attention_method != "perlin":
            raise NotImplementedError("decode is ported for the SEA student ('perlin') only")
        return self.perlin.init_state(batch, max_len, dtype)

    def decode(self, hidden_states: torch.Tensor, state: SeaDecodeState):
        """One decode step: (N, 1, E) -> (attention output, new state)."""
        q, k, v = self._qkv(hidden_states)
        out, new_state = self.perlin.decode(q, k, v, state)
        return self.out_proj(out), new_state

    def prefill(self, hidden_states: torch.Tensor, causal_mask: torch.Tensor, max_len: int):
        """The prompt in one pass: the SEA forward for its output (the
        benchmark path, kernel K1, when `sea.use_pallas`) and the decode
        cache built in parallel (`SeaAttention.prefill_state`)."""
        q, k, v = self._qkv(hidden_states)
        out = self.perlin(q, k, v, q, k, v, q, k, causal_mask,
                          benchmarking=self.cfg.sea.use_pallas)
        state = self.perlin.prefill_state(q, k, v, max_len)
        return self.out_proj(out.context_layer), state

    def decode_paged(self, hidden_states, state, pool_k, pool_v, pages):
        """One decode step against this layer's page pools (the serving path)."""
        q, k, v = self._qkv(hidden_states)
        out, new_state, pool_k, pool_v = self.perlin.decode_paged(
            q, k, v, state, pool_k, pool_v, pages)
        return self.out_proj(out), new_state, pool_k, pool_v


class OptDecoderLayer(nn.Module):
    """Pre-LN decoder layer."""

    def __init__(self, cfg: OptConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = OptAttention(cfg)
        self.self_attn_layer_norm = _layer_norm(cfg.hidden_size)
        self.fc1 = Dense(cfg.hidden_size, cfg.ffn_dim)
        self.fc2 = Dense(cfg.ffn_dim, cfg.hidden_size)
        self.final_layer_norm = _layer_norm(cfg.hidden_size)

    def forward(self, hidden_states, causal_mask, teacher=None, *, benchmarking=False,
                training=False, jitter=None):
        """Returns (hidden states in the input's type, aux_loss | None,
        teacher capture | None)."""
        c = self.cfg
        in_dtype = hidden_states.dtype
        if c.sea.layerwise and training:
            # every layer optimises its own distillation loss: no gradient
            # crosses a layer boundary
            hidden_states = hidden_states.detach()

        def attend(h):
            h, aux_loss, capture = self.self_attn(
                h, causal_mask, teacher, benchmarking=benchmarking, training=training,
                jitter=jitter,
            )
            return F.dropout(h, c.dropout, training), aux_loss, capture

        h, aux_loss, capture = self._around_attention(hidden_states, attend, training)
        # the layer outputs stay in compute_dtype (the float32 islands and
        # parameters would otherwise promote the residual stream)
        return h.to(in_dtype), aux_loss, capture

    def _around_attention(self, hidden_states, attend, training: bool = False):
        """The layer around one attention call `attend(h) -> (h, *rest)`;
        returns (hidden states, *rest). Decode and prefill are inference
        (`training=False`: the FFN's dropout is the identity)."""
        c = self.cfg
        residual = hidden_states
        h = hidden_states
        if c.do_layer_norm_before:
            h = self.self_attn_layer_norm(h)
        h, *rest = attend(h)
        h = residual + h
        if not c.do_layer_norm_before:
            h = self.self_attn_layer_norm(h)
        residual = h
        if c.do_layer_norm_before:
            h = self.final_layer_norm(h)
        h = self.fc2(torch.relu(self.fc1(h)))
        h = residual + F.dropout(h, c.dropout, training)
        if not c.do_layer_norm_before:
            h = self.final_layer_norm(h)
        return (h, *rest)

    def decode(self, hidden_states, state):
        return self._around_attention(hidden_states, lambda h: self.self_attn.decode(h, state))

    def prefill(self, hidden_states, causal_mask, max_len: int):
        """The parallel twin of `decode`: (layer output, decode state)."""
        return self._around_attention(
            hidden_states, lambda h: self.self_attn.prefill(h, causal_mask, max_len))

    def decode_paged(self, hidden_states, state, pool_k, pool_v, pages):
        return self._around_attention(
            hidden_states,
            lambda h: self.self_attn.decode_paged(h, state, pool_k, pool_v, pages))


def _scan_body(layer: nn.Module, h: torch.Tensor, bundle, benchmarking: bool):
    """One layer as JAX's scan body calls it (no `training`, no jitter):
    (hidden states, aux loss, 0.0 where the layer has none)."""
    h, aux, _ = layer(h, bundle, benchmarking=benchmarking)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def scan_layers(cfg, layers: Sequence[nn.Module], h: torch.Tensor, bundle):
    """The layer stack as the JAX package's `nn.scan` body runs it (OPT's
    `_LayerScanBody`, LLaMA's `_LlamaScanBody`), under `nn.remat` with
    `cfg.scan_remat`: returns (hidden states, mean of the per-layer aux
    values). With `scan_remat` and grad enabled each layer runs under a
    non-reentrant checkpoint that keeps its inputs alone. The recompute must
    pick the same top-k mask as the forward, so it refuses cuDNN's
    benchmark mode, under which a convolution of the predictor may take
    another algorithm, and other bits, the second time."""
    remat = cfg.scan_remat and torch.is_grad_enabled()
    if remat and h.is_cuda and torch.backends.cudnn.benchmark:
        raise RuntimeError(
            "scan_remat with torch.backends.cudnn.benchmark on: the recompute could "
            "choose another convolution algorithm and so another top-k mask")
    auxes = []
    for layer in layers:
        if remat:
            h, aux = checkpoint(_scan_body, layer, h, bundle, cfg.scan_benchmarking,
                                use_reentrant=False)
        else:
            h, aux = _scan_body(layer, h, bundle, cfg.scan_benchmarking)
        auxes.append(aux)
    return h, torch.stack(auxes).mean()


class OptModel(nn.Module):
    """OPT decoder stack: `embed`, the layer loop (or `scan_layers`),
    `finalize`."""

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
        h = h.to(COMPUTE_DTYPES[self.cfg.compute_dtype])
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
        `teacher_outputs` and `jitter` hold one entry per layer. Under
        `cfg.scan_layers` the layers run as `scan_layers` runs them
        (`benchmarking`, `training` and `jitter` unread)."""
        h, causal_mask = self.embed(input_ids, attention_mask_1d)
        if self.cfg.scan_layers:
            check_plain_scan_forward(teacher_outputs, output_hidden_states)
            h, aux_loss = scan_layers(self.cfg, self.layers, h, causal_mask)
            return self.finalize(h), None, [], aux_loss
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


def check_plain_scan_forward(teacher_outputs, output_hidden_states: bool):
    """The scanned forward's limits (JAX's assertion, `opt.py:594-597`)."""
    if teacher_outputs is not None or output_hidden_states:
        raise ValueError("scan_layers runs the plain forward only: no teacher outputs, "
                         "no hidden states (use the loop path for KD and introspection)")


class CausalLMGeneration:
    """Decode and generation over a causal LM's SEA decode cache, shared by
    `OptForCausalLM` and `models.llama.LlamaForCausalLM` (the JAX package's
    LLaMA reuses OPT's loops the same way). A model supplies `cfg`,
    `model.embed_tokens`, `model.embed(ids, mask) -> (h, bundle)`,
    `model.layers` (each with `self_attn.init_state`, `decode(h, state,
    *extra)`, `decode_paged(h, state, pool_k, pool_v, pages, *extra)` and
    `prefill(h, bundle, max_len)`), `model.finalize`, `logits` and
    `_embed_step(token_ids, position) -> (h, extra)`: a step's embedded
    tokens and what its layers' decode takes besides (OPT nothing, its
    positions being in the embedding; LLaMA the step's rotary tables)."""

    # ------------------------------------------------------------------
    # decode and generation (inference: no autograd)
    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def init_decode_states(self, batch: int, max_len: int, dtype=torch.float32):
        return [layer.self_attn.init_state(batch, max_len, dtype) for layer in self.model.layers]

    @torch.no_grad()
    def prefill_parallel(self, prompt_ids: torch.Tensor, max_len: int, last_only: bool = False):
        """The whole prompt (N, P) in one batched forward in place of P
        `decode_step`s: (logits (N, P, V), per-layer decode states at
        position P). Each layer's state is built from the forward's hidden
        states; its prefix sums run in another order than the sequential
        loop's. `last_only` projects only the last position's logits
        (N, 1, V), all that generation needs."""
        N, P = prompt_ids.shape
        h, bundle = self.model.embed(prompt_ids, torch.ones_like(prompt_ids))
        states = []
        for layer in self.model.layers:
            h, st = layer.prefill(h, bundle, max_len)
            states.append(st)
        h = self.model.finalize(h)
        if last_only:
            h = h[:, -1:]
        return self.logits(h), states

    def _prefill(self, prompt_ids: torch.Tensor, max_len: int, parallel: bool):
        """The generation loops' prompt step: (states at position P, the
        last position's logits (N, V))."""
        N, P = prompt_ids.shape
        if parallel:
            logits, states = self.prefill_parallel(prompt_ids, max_len, last_only=True)
            return states, logits[:, -1]
        states = self.init_decode_states(N, max_len)
        position = torch.zeros((), dtype=torch.int32, device=prompt_ids.device)
        for t in range(P):
            logits, states = self.decode_step(prompt_ids[:, t:t + 1], position + t, states)
        return states, logits[:, 0]

    @staticmethod
    def _decode_pos(position: torch.Tensor) -> torch.Tensor:
        """() -> (1, 1) (lockstep), (N,) -> (N, 1) (per slot)."""
        return position.reshape(1, 1) if position.dim() == 0 else position[:, None]

    @torch.no_grad()
    def decode_step(self, token_ids: torch.Tensor, position, states: List[SeaDecodeState]):
        """One step: token_ids (N, 1); position a () tensor or int (0-based,
        rows in lockstep) or an (N,) tensor (per slot); states one
        `SeaDecodeState` per layer. Returns (logits (N, 1, V), new states)."""
        h, extra = self._embed_step(token_ids, position)
        new_states = []
        for layer, st in zip(self.model.layers, states):
            h, st = layer.decode(h, st, *extra)
            new_states.append(st)
        return self.logits(self.model.finalize(h)), new_states

    @torch.no_grad()
    def decode_step_paged(self, token_ids, position, states, pool_k, pool_v, pages):
        """One serving step over paged K/V pools: pool_k, pool_v (L, P,
        page_size, H, D), layer l's pool at index l; pages (N, max_pages), one
        page table for every layer (a page id addresses the same slots in
        each layer's pool). The pools are written in place. Returns (logits,
        new states, pool_k, pool_v)."""
        h, extra = self._embed_step(token_ids, position)
        new_states = []
        for li, (layer, st) in enumerate(zip(self.model.layers, states)):
            h, st, _, _ = layer.decode_paged(h, st, pool_k[li], pool_v[li], pages, *extra)
            new_states.append(st)
        return self.logits(self.model.finalize(h)), new_states, pool_k, pool_v

    @torch.no_grad()
    def generate_greedy(self, prompt_ids: torch.Tensor, max_len: int, num_steps: int,
                        parallel_prefill: bool = False) -> torch.Tensor:
        """Greedy continuation (N, num_steps) of the prompts (N, P): the
        prompt through the decode cache (P decode steps, or one batched
        forward with `parallel_prefill`), then one step a token. The loop
        stays on the device: no token is read back before the end."""
        N, P = prompt_ids.shape
        states, last_logits = self._prefill(prompt_ids, max_len, parallel_prefill)
        position = torch.full((), P, dtype=torch.int32, device=prompt_ids.device)
        tokens = []
        for i in range(num_steps):
            nxt = torch.argmax(last_logits, dim=-1)[:, None]
            logits, states = self.decode_step(nxt, position + i, states)
            last_logits = logits[:, 0]
            tokens.append(nxt[:, 0])
        return torch.stack(tokens, dim=1)

    @torch.no_grad()
    def generate_sample(self, prompt_ids: torch.Tensor, max_len: int, num_steps: int,
                        generator: Optional[torch.Generator] = None, temperature=1.0,
                        top_k=0, top_p=1.0, parallel_prefill: bool = False,
                        gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sampled continuation (N, num_steps): temperature, then top-k, then
        top-p, then a categorical draw (`ops.sampling.sample_logits`); each
        parameter a scalar or per row (N,), temperature <= 0 greedy for that
        row. Step i's draws are the i-th (N, V) block of Gumbel noise from
        `generator` (as JAX folds the step into its key), or `gumbel[i]`
        when the draws (num_steps, N, V) are given."""
        N, P = prompt_ids.shape
        states, last_logits = self._prefill(prompt_ids, max_len, parallel_prefill)
        position = torch.full((), P, dtype=torch.int32, device=prompt_ids.device)
        tokens = []
        for i in range(num_steps):
            nxt = sample_logits(
                last_logits, temperature, top_k, top_p, generator=generator,
                gumbel=None if gumbel is None else gumbel[i],
            )[:, None]
            logits, states = self.decode_step(nxt, position + i, states)
            last_logits = logits[:, 0]
            tokens.append(nxt[:, 0])
        return torch.stack(tokens, dim=1)

    @torch.no_grad()
    def generate_beam(self, prompt_ids: torch.Tensor, max_len: int, num_steps: int,
                      beam_size: int = 4, length_penalty: float = 1.0,
                      parallel_prefill: bool = False):
        """Beam search over the decode cache, a fixed number of steps (no
        early stop at EOS). Returns (tokens (N, beam_size, num_steps),
        scores (N, beam_size)), best first; a score is the beam's summed
        log-probability over num_steps ** length_penalty. Ties between
        candidates go to the lower index, as `jax.lax.top_k` breaks them."""
        N, P = prompt_ids.shape
        B = beam_size
        V = self.cfg.vocab_size
        device = prompt_ids.device

        # the prompt once at batch N, then every state row repeated per beam
        states, last_logits = self._prefill(prompt_ids, max_len, parallel_prefill)
        beam_logp, first_tok = _top_k_stable(torch.log_softmax(last_logits.float(), -1), B)
        states = [_map_rows(st, lambda x: torch.repeat_interleave(x, B, dim=0))
                  for st in states]
        last_tok = first_tok.reshape(N * B, 1)
        position = torch.full((), P, dtype=torch.int32, device=device)
        base = torch.arange(N, device=device)[:, None] * B
        toks, parents = [], []
        for i in range(num_steps - 1):
            logits, states = self.decode_step(last_tok, position + i, states)
            logp = torch.log_softmax(logits[:, 0].float(), -1)
            total = beam_logp.reshape(N, B, 1) + logp.reshape(N, B, V)
            beam_logp, flat_idx = _top_k_stable(total.reshape(N, B * V), B)
            parent = flat_idx // V  # (N, B)
            tok = flat_idx % V
            # the states follow their surviving parent beams
            gather_idx = (base + parent).reshape(-1)
            states = [_map_rows(st, lambda x: x.index_select(0, gather_idx)) for st in states]
            last_tok = tok.reshape(N * B, 1)
            toks.append(tok)
            parents.append(parent)

        # walk the beams' paths back from the last step
        beam_ptr = torch.arange(B, device=device)[None, :].expand(N, B)
        rev = []
        for tok_t, parent_t in zip(reversed(toks), reversed(parents)):
            rev.append(torch.gather(tok_t, 1, beam_ptr))
            beam_ptr = torch.gather(parent_t, 1, beam_ptr)
        first = torch.gather(first_tok, 1, beam_ptr)
        seq = torch.stack([first] + rev[::-1], dim=-1)  # (N, B, num_steps)
        return seq, beam_logp / (num_steps ** length_penalty)


class OptForCausalLM(CausalLMGeneration, nn.Module):
    """LM head tied to the input embedding (OPT convention). Built on
    `device` with seeded random weights (`seed=None` leaves them
    uninitialised, for `load_state_dict`)."""

    def __init__(self, cfg: OptConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}")
        self.cfg = cfg
        self.model = OptModel(cfg)
        if seed is not None:
            init_random_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        w = self.model.embed_tokens.weight
        dtype = promote(h, w)
        return h.to(dtype) @ w.to(dtype).T

    def _embed_step(self, token_ids: torch.Tensor, position):
        position = torch.as_tensor(position, device=token_ids.device)
        h = self.model.embed_tokens(token_ids)
        # OPT's learned positions sit 2 rows up; the layers' decode takes no
        # more than the hidden states
        return h + self.model.embed_positions(self._decode_pos(position).long() + 2), ()

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
        logit_chunk: Optional[int] = None,
    ):
        """With `labels` and `logit_chunk` the loss is the chunked cross
        entropy through the tied embedding and `logits` is None."""
        h, hidden_states, captures, aux_loss = self.model(
            input_ids, attention_mask_1d, teacher_outputs, benchmarking=benchmarking,
            training=training, jitter=jitter, output_hidden_states=output_hidden_states,
            output_captures=output_captures,
        )
        logits, loss = lm_loss(self, h, labels, logit_chunk)
        return {"logits": logits, "loss": loss, "hidden_states": hidden_states,
                "teacher_captures": captures, "aux_loss": aux_loss}


def _top_k_stable(x: torch.Tensor, k: int):
    """The k largest entries along the last axis and their indices, ties to
    the lower index (`jax.lax.top_k`'s order; `torch.topk` leaves it
    unspecified). `+ 0.0` sorts -0.0 with +0.0."""
    idx = torch.sort(-x + 0.0, dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _map_rows(state: SeaDecodeState, fn) -> SeaDecodeState:
    """`fn` on every field with a leading batch axis; () fields kept."""
    return SeaDecodeState(*(fn(x) if x.dim() > 0 else x for x in state))


def lm_loss(lm, h: torch.Tensor, labels: Optional[torch.Tensor], logit_chunk: Optional[int]):
    """(logits, loss) of a causal LM's final hidden states: with `labels` and
    `logit_chunk`, no logits and the chunked cross entropy through
    `lm.logits`; else `lm.logits(h)` and its cross entropy (None without
    labels)."""
    if labels is not None and logit_chunk:
        return None, chunked_cross_entropy_shifted(h, lm.logits, labels, logit_chunk)
    logits = lm.logits(h)
    return logits, cross_entropy_shifted(logits, labels) if labels is not None else None


def logit_chunk_size(t: int, chunk: int) -> int:
    """The chunk the sequence is cut into: `chunk` if it divides `t`, else
    the largest divisor of `t` below it (a gcd can collapse to 1)."""
    c = int(chunk)
    if t % c:
        c = next(d for d in range(min(c, t), 0, -1) if t % d == 0)
    return c


def next_token_labels(labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """labels shifted by one: position t's target is labels[:, t + 1], and
    `ignore_index` after the last."""
    pad = torch.full((labels.shape[0], 1), ignore_index, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([labels[:, 1:], pad], dim=1)


def chunk_sums(fn, seqs: Sequence[torch.Tensor], chunk: int):
    """The sums over the chunks of the sequence (axis 1, cut by
    `logit_chunk_size`) of fn's tuple of outputs on each chunk of `seqs`.
    While grad is enabled each chunk runs under a non-reentrant checkpoint,
    so one chunk's intermediates (its (N, C, V) logits) are live at a time,
    in the forward and in the backward."""
    T = seqs[0].shape[1]
    C = logit_chunk_size(T, chunk)
    sums = None
    for s in range(0, T, C):
        part = [x[:, s:s + C] for x in seqs]
        if torch.is_grad_enabled():
            out = checkpoint(fn, *part, use_reentrant=False)
        else:
            out = fn(*part)
        sums = out if sums is None else tuple(a + b for a, b in zip(sums, out))
    return sums


def chunked_cross_entropy_shifted(
    h: torch.Tensor, logits_fn, labels: torch.Tensor, chunk: int, ignore_index: int = -100,
) -> torch.Tensor:
    """`cross_entropy_shifted` of the logits `logits_fn(h)`, computed per
    chunk of the sequence (`chunk_sums`): h (N, T, E) the finalized hidden
    states, `logits_fn` the LM head (`logits` of a causal LM). The labels
    are shifted once, so the chunks need no overlap. The same sums as the
    unchunked loss, added in another order."""
    lab_next = next_token_labels(labels, ignore_index)

    def nll(h_c, lab_c):
        logp = torch.log_softmax(logits_fn(h_c).float(), -1)
        return (masked_nll(logp, lab_c, ignore_index),)

    (total,) = chunk_sums(nll, (h, lab_next), chunk)
    return total / torch.clamp((lab_next != ignore_index).sum(), min=1)


def masked_nll(logp: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100
               ) -> torch.Tensor:
    """The summed NLL of `labels` under the log-probabilities `logp` (...,
    V), positions labelled `ignore_index` left out."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum()


def cross_entropy_shifted(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100
) -> torch.Tensor:
    """Next-token cross entropy with -100 masking."""
    shift_labels = labels[:, 1:]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = masked_nll(logp, shift_labels, ignore_index)
    return nll / torch.clamp((shift_labels != ignore_index).sum(), min=1)


# ---------------------------------------------------------------------------
# The scanned decode helpers (JAX `opt.py:1036-1120`): the JAX package runs
# the layer stack as one `lax.scan` over stacked parameters and carries the
# per-layer decode states stacked on a leading layer axis. The port drives
# its loop decode and keeps that layout at the boundary.


def stack_states(states: Sequence[SeaDecodeState]) -> SeaDecodeState:
    """Per-layer decode states -> one state, every field stacked on axis 0."""
    return SeaDecodeState(*(torch.stack(fields) for fields in zip(*states)))


def unstack_states(stacked: SeaDecodeState) -> List[SeaDecodeState]:
    """The inverse of `stack_states`."""
    return [SeaDecodeState(*(x[i] for x in stacked)) for i in range(stacked[0].shape[0])]


def scan_decode_step(model: CausalLMGeneration, token_ids: torch.Tensor, position,
                     states: SeaDecodeState):
    """One decode step (`decode_step`) on stacked states: (logits (N, 1, V),
    the new states stacked)."""
    logits, new_states = model.decode_step(token_ids, position, unstack_states(states))
    return logits, stack_states(new_states)


def scan_prefill_parallel(model: CausalLMGeneration, prompt_ids: torch.Tensor, max_len: int,
                          last_only: bool = True):
    """`prefill_parallel` with the per-layer states stacked: (logits, stacked
    states at position P)."""
    logits, states = model.prefill_parallel(prompt_ids, max_len, last_only=last_only)
    return logits, stack_states(states)


def scan_generate_greedy(model: CausalLMGeneration, prompt_ids: torch.Tensor, max_len: int,
                         num_steps: int) -> torch.Tensor:
    """Greedy generation from one batched prefill (JAX's scanned prefill,
    then scanned decode steps): (N, num_steps) tokens."""
    return model.generate_greedy(prompt_ids, max_len, num_steps, parallel_prefill=True)
