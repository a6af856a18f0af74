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
compiler; the port has no such fields and runs a plain layer loop.

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

Not ported yet: the other attention methods, the chunked cross entropy and
the `scan_*` decode helpers of scanned models.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SeaConfig, opt_config
from ..ops.masks import fp_min_for
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
        self.q_proj = Dense(E, E)
        self.k_proj = Dense(E, E)
        self.v_proj = Dense(E, E)
        self.out_proj = Dense(E, E)
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


def _top_k_stable(x: torch.Tensor, k: int):
    """The k largest entries along the last axis and their indices, ties to
    the lower index (`jax.lax.top_k`'s order; `torch.topk` leaves it
    unspecified). `+ 0.0` sorts -0.0 with +0.0."""
    idx = torch.sort(-x + 0.0, dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _map_rows(state: SeaDecodeState, fn) -> SeaDecodeState:
    """`fn` on every field with a leading batch axis; () fields kept."""
    return SeaDecodeState(*(fn(x) if x.dim() > 0 else x for x in state))


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
