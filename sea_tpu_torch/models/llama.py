"""LLaMA decoder with switchable attention (PyTorch port of `sea_tpu/models/llama.py`).

RMSNorm, rotary position embeddings, the SwiGLU MLP, an untied LM head and
optional grouped-query attention (`num_kv_heads < num_heads`), with the JAX
model's design kept as it is:

  * RoPE is applied to q and k before the SEA module, so the FAVOR+
    estimator and the sparse attention both see position-mixed projections;
  * q is scaled by 1/sqrt(D) after RoPE (the SEA kernels take pre-scaled q);
  * GQA keys and values are expanded to the full head count before SEA (the
    mask budget is per query head), and the decode cache stores the roped,
    expanded keys;
  * `LlamaModel.embed` returns (h, (causal_mask, cos, sin)), the position
    bundle each layer unpacks.

`attention_method` is 'perlin' (the SEA student: the benchmark path, kernel
K1, with `benchmarking=True`; with `training=True` and the SEA config's
`use_fused_train`, no KD truths, the differentiable fused path, kernels
K2-K4, on the (N, 1, T, T) causal mask, as the JAX model hands it to
`SeaAttention`; the dense train path otherwise, KD's student) or 'none' (the
dense teacher, whose layers capture their clamped scores and context), or
one of OPT's causal baseline students, 'performer', 'reformer', 'sinkhorn'
and 'cosformer' (`opt.causal_baseline_context` on the roped, expanded
heads; decode stays the SEA student's).
Training runs through `training.longctx.train_step(s)` (task-only, fused)
and `training.opt_trainer.OptTrainer(model="llama-*")` (KD, dense path).
Decode and generation are OPT's (`opt.CausalLMGeneration`): this model
supplies its step embedding and the step's rotary tables (`_embed_step`).

Types follow the JAX model: `compute_dtype` is the type `embed` casts the
embedding to and the type `forward` casts each layer's output back to;
inside a layer `Dense` and `RMSNorm` compute in the promoted type of input
and parameters (flax's rule), RoPE rounds after each product and the sum,
q's scale is rounded to q's type first (a weak-typed Python float), and the
SwiGLU's sigmoid is XLA's expansion (`modules.silu`). Decode never casts:
`decode_step` embeds in the parameters' type. The builders `llama_7b` and
`llama_13b` are the JAX package's (bfloat16 compute; heads of 128, which
K1-K4 take on the card).

The long-context memory plan is OPT's (`models/opt.py`): `scan_layers` runs
the stack as JAX's `_LlamaScanBody` does (`opt.scan_layers`), `scan_remat`
checkpoints each layer under grad, and `forward(..., labels=,
logit_chunk=)` streams the cross entropy through the untied, bias-free head
per chunk, with `logits=None`.

LoRA (`sea.lora_enabled`, `sea.lora_in_approx_enabled`) adds the SEA
student's deltas as JAX's model does (`models/lora.py`): each roped on its
own, q's scaled, k's and v's repeated for GQA; prefill and decode take
none.

`external_layers` builds the shell of JAX's pipeline stages: embed,
finalize and the head with no layers (`parallel/pp.py` runs the stack).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..config import SeaConfig, opt_config
from .attention import SeaAttention, init_random_, softmax_fp32
from .lora import add_lora, lora_branches
from .modules import Dense, RMSNorm, silu
from .opt import (
    BASELINE_METHODS,
    COMPUTE_DTYPES,
    CausalLMGeneration,
    JitterDraws,
    LayerTeacherOutput,
    OptForCausalLM,
    add_causal_baseline,
    build_causal_mask,
    causal_baseline_context,
    check_plain_scan_forward,
    lm_loss,
    scan_layers,
)
from .state import SeaDecodeState


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    # grouped-query attention: number of distinct K/V heads (None = MHA)
    num_kv_heads: Optional[int] = None
    intermediate_size: int = 11008
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    attention_method: str = "perlin"
    compute_dtype: str = "float32"
    # the scanned stack (`opt.scan_layers`) and the pipeline's layerless
    # shell (`external_layers`)
    scan_layers: bool = False
    scan_benchmarking: bool = False
    scan_remat: bool = False
    external_layers: bool = False
    sea: SeaConfig = dataclasses.field(default_factory=SeaConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def llama_tiny(
    attention_method: str = "perlin",
    sea: Optional[SeaConfig] = None,
    num_kv_heads: Optional[int] = None,
) -> LlamaConfig:
    """Test-scale geometry (2 layers, 4 heads of 8, optional GQA)."""
    sea = sea or SeaConfig(
        num_heads=4, head_dim=8, predictor_length=8, k=2,
        performer_nb_factor=1, causal=True, max_position_embeddings=128,
    ).validate()
    return LlamaConfig(
        vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
        num_kv_heads=num_kv_heads, intermediate_size=64,
        max_position_embeddings=128,
        attention_method=attention_method, sea=sea,
    )


def llama_7b(attention_method: str = "perlin", sea: Optional[SeaConfig] = None) -> LlamaConfig:
    """LLaMA-7b: hidden 4096, 32 layers, 32 heads of 128, SwiGLU 11008,
    vocabulary 32000, bfloat16 compute."""
    return LlamaConfig(
        attention_method=attention_method,
        compute_dtype="bfloat16",
        sea=sea if sea is not None else opt_config(num_heads=32, head_dim=128),
    )


def llama_13b(attention_method: str = "perlin", sea: Optional[SeaConfig] = None) -> LlamaConfig:
    """LLaMA-13b, the reference's headline SEA-13B geometry: hidden 5120,
    40 layers, 40 heads of 128, SwiGLU 13824, bfloat16 compute."""
    return LlamaConfig(
        hidden_size=5120,
        num_layers=40,
        num_heads=40,
        intermediate_size=13824,
        attention_method=attention_method,
        compute_dtype="bfloat16",
        sea=sea if sea is not None else opt_config(num_heads=40, head_dim=128),
    )


# ---------------------------------------------------------------- rotary


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float = 10000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin tables for rotary embeddings (HF's half-split
    convention): positions, an integer tensor of any shape P, give two
    float32 tensors of shape P + (head_dim,) whose second half repeats the
    first."""
    steps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (steps / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., T, D) by cos and sin broadcastable to it, both cast to
    x's type first (each product and the sum rounded to it)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos.to(x.dtype) + rotated * sin.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(N, Hkv, T, D) -> (N, Hkv·n_rep, T, D): each K/V head repeated for
    its n_rep query heads (head-major)."""
    if n_rep == 1:
        return x
    N, H, T, D = x.shape
    return x[:, :, None].expand(N, H, n_rep, T, D).reshape(N, H * n_rep, T, D)


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """x · factor with the Python float rounded to x's type first, as JAX
    takes a weak-typed constant."""
    return x * float(torch.tensor(factor, dtype=x.dtype))


# ------------------------------------------------------------- modules


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) · up(x)), bias-free."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        E, inner = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(E, inner, bias=False)
        self.up_proj = Dense(E, inner, bias=False)
        self.down_proj = Dense(inner, E, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    """Self-attention dispatcher with RoPE and GQA ('perlin' or 'none')."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        if cfg.attention_method not in ("perlin", "none", *BASELINE_METHODS):
            raise ValueError(f"attention_method {cfg.attention_method!r}")
        self.cfg = cfg
        E, kv_width = cfg.hidden_size, cfg.kv_heads * cfg.head_dim
        self.q_proj = Dense(E, E, bias=False)
        self.k_proj = Dense(E, kv_width, bias=False)
        self.v_proj = Dense(E, kv_width, bias=False)
        self.o_proj = Dense(E, E, bias=False)
        if cfg.attention_method == "perlin":
            self.perlin = SeaAttention(cfg.sea, device="cpu", seed=None)
            add_lora(self, cfg.sea, E, E, kv_width)
        elif cfg.attention_method != "none":
            add_causal_baseline(self, cfg.attention_method, E, cfg.num_heads, cfg.sea)

    def _heads(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        N, T, _ = x.shape
        return x.reshape(N, T, heads, self.cfg.head_dim).permute(0, 2, 1, 3)

    def _qkv(self, hidden_states, cos, sin):
        """Projections, RoPE, GQA expansion and q's 1/sqrt(D)."""
        c = self.cfg
        n_rep = c.num_heads // c.kv_heads
        q = apply_rope(self._heads(self.q_proj(hidden_states), c.num_heads), cos, sin)
        q = _scale(q, c.head_dim ** -0.5)
        k = apply_rope(self._heads(self.k_proj(hidden_states), c.kv_heads), cos, sin)
        v = self._heads(self.v_proj(hidden_states), c.kv_heads)
        return q, repeat_kv(k, n_rep), repeat_kv(v, n_rep)

    def forward(
        self,
        hidden_states: torch.Tensor,
        bundle,  # (causal_mask (N, 1, T, T), cos (N, 1, T, D), sin (N, 1, T, D))
        teacher: Optional[LayerTeacherOutput] = None,
        *,
        benchmarking: bool = False,
        training: bool = False,
        jitter: Optional[JitterDraws] = None,
    ):
        """Returns (attn_output (N, T, E), aux_loss | None, teacher capture
        | None), as `OptAttention.forward`."""
        causal_mask, cos, sin = bundle
        N, T, E = hidden_states.shape
        q, k, v = self._qkv(hidden_states, cos, sin)

        if self.cfg.attention_method == "none":
            scores = torch.einsum("nhtd,nhsd->nhts", q, k) + causal_mask
            scores = torch.clamp(scores, min=torch.finfo(scores.dtype).min)
            probs = softmax_fp32(scores, -1)
            ctx = torch.einsum("nhts,nhsd->nhtd", probs, v)
            ctx = ctx.permute(0, 2, 1, 3).reshape(N, T, E)
            capture = LayerTeacherOutput(attention_scores=scores, context_layer=ctx)
            return self.o_proj(ctx), None, capture
        if self.cfg.attention_method != "perlin":
            ctx = causal_baseline_context(self, self.cfg.attention_method, q, k, v, causal_mask,
                                          self.cfg.sea.k, hidden_states.dtype, jitter)
            return self.o_proj(ctx), None, None

        # the LoRA deltas, each roped on its own and k's and v's repeated
        # for GQA (none in prefill and decode, as in JAX)
        c = self.cfg
        n_rep = c.num_heads // c.kv_heads
        branches = lora_branches(
            self, c.sea, hidden_states, q, k, v,
            lambda d: _scale(apply_rope(self._heads(d, c.num_heads), cos, sin),
                             c.head_dim ** -0.5),
            lambda d: repeat_kv(apply_rope(self._heads(d, c.kv_heads), cos, sin), n_rep),
            lambda d: repeat_kv(self._heads(d, c.kv_heads), n_rep),
        )
        out = self.perlin(
            *branches, causal_mask,
            attention_scores_truth=teacher.attention_scores if teacher else None,
            context_layer_truth=teacher.context_layer if teacher else None,
            benchmarking=benchmarking, training=training, jitter=jitter,
        )
        return self.o_proj(out.context_layer), out.loss, None

    def _check_decode(self):
        if self.cfg.attention_method != "perlin":
            raise NotImplementedError("decode is ported for the SEA student ('perlin') only")

    def init_state(self, batch: int, max_len: int, dtype=torch.float32) -> SeaDecodeState:
        self._check_decode()
        return self.perlin.init_state(batch, max_len, dtype)

    def decode(self, hidden_states: torch.Tensor, state: SeaDecodeState, cos, sin):
        """One decode step; cos and sin are the step's rotary tables
        ((N, 1, 1, D)-broadcastable)."""
        self._check_decode()
        q, k, v = self._qkv(hidden_states, cos, sin)
        out, new_state = self.perlin.decode(q, k, v, state)
        return self.o_proj(out), new_state

    def decode_paged(self, hidden_states, state, pool_k, pool_v, pages, cos, sin):
        self._check_decode()
        q, k, v = self._qkv(hidden_states, cos, sin)
        out, new_state, pool_k, pool_v = self.perlin.decode_paged(
            q, k, v, state, pool_k, pool_v, pages)
        return self.o_proj(out), new_state, pool_k, pool_v

    def prefill(self, hidden_states: torch.Tensor, bundle, max_len: int):
        """The prompt in one pass: the SEA forward for its output (the
        benchmark path, kernel K1, when `sea.use_pallas`) and the decode
        cache of roped, expanded keys built in parallel."""
        self._check_decode()
        causal_mask, cos, sin = bundle
        q, k, v = self._qkv(hidden_states, cos, sin)
        out = self.perlin(q, k, v, q, k, v, q, k, causal_mask,
                          benchmarking=self.cfg.sea.use_pallas)
        state = self.perlin.prefill_state(q, k, v, max_len)
        return self.o_proj(out.context_layer), state


class LlamaDecoderLayer(nn.Module):
    """Pre-RMSNorm decoder layer: input_layernorm -> attention -> residual
    -> post_attention_layernorm -> SwiGLU -> residual."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = LlamaAttention(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, hidden_states, bundle, teacher=None, *, benchmarking=False,
                training=False, jitter=None):
        """Returns (hidden states in the input's type, aux_loss | None,
        teacher capture | None)."""
        in_dtype = hidden_states.dtype
        if self.cfg.sea.layerwise and training:
            hidden_states = hidden_states.detach()
        h, aux_loss, capture = self._around_attention(
            hidden_states, lambda h: self.self_attn(
                h, bundle, teacher, benchmarking=benchmarking, training=training,
                jitter=jitter))
        return h.to(in_dtype), aux_loss, capture

    def _around_attention(self, hidden_states, attend):
        """The layer around one attention call `attend(h) -> (h, *rest)`;
        returns (hidden states in the promoted type, *rest)."""
        h, *rest = attend(self.input_layernorm(hidden_states))
        h = hidden_states + h
        h = h + self.mlp(self.post_attention_layernorm(h))
        return (h, *rest)

    def decode(self, hidden_states, state, cos, sin):
        return self._around_attention(
            hidden_states, lambda h: self.self_attn.decode(h, state, cos, sin))

    def decode_paged(self, hidden_states, state, pool_k, pool_v, pages, cos, sin):
        return self._around_attention(
            hidden_states,
            lambda h: self.self_attn.decode_paged(h, state, pool_k, pool_v, pages, cos, sin))

    def prefill(self, hidden_states, bundle, max_len: int):
        """The parallel twin of `decode`: (layer output, decode state)."""
        return self._around_attention(
            hidden_states, lambda h: self.self_attn.prefill(h, bundle, max_len))


class LlamaModel(nn.Module):
    """The LLaMA decoder stack: `embed` (with the position bundle), the
    layer loop (or `opt.scan_layers`), `finalize`."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            [] if cfg.external_layers else [LlamaDecoderLayer(cfg) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def embed(self, input_ids: torch.Tensor, attention_mask_1d: torch.Tensor):
        c = self.cfg
        N, T = input_ids.shape
        h = self.embed_tokens(input_ids).to(COMPUTE_DTYPES[c.compute_dtype])
        causal_mask = build_causal_mask(attention_mask_1d, T, h.dtype)
        # left-padding-aware positions, as OPT's cumsum positions
        positions = torch.clamp(torch.cumsum(attention_mask_1d, dim=1) * attention_mask_1d - 1,
                                min=0)
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        # (N, T, D) -> (N, 1, T, D), broadcasting over the heads
        return h, (causal_mask, cos[:, None], sin[:, None])

    def finalize(self, h: torch.Tensor) -> torch.Tensor:
        return self.norm(h)

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
        captures (empty without `output_captures`), aux_loss); under
        `cfg.scan_layers` the layers run as `opt.scan_layers` runs them."""
        h, bundle = self.embed(input_ids, attention_mask_1d)
        if self.cfg.scan_layers:
            check_plain_scan_forward(teacher_outputs, output_hidden_states)
            h, aux_loss = scan_layers(self.cfg, self.layers, h, bundle)
            return self.finalize(h), None, [], aux_loss
        hidden_states = [h] if output_hidden_states else None
        captures: List[LayerTeacherOutput] = []
        aux_losses = []
        for i, layer in enumerate(self.layers):
            h, aux, capture = layer(
                h, bundle, teacher_outputs[i] if teacher_outputs is not None else None,
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


class LlamaForCausalLM(CausalLMGeneration, nn.Module):
    """Untied LM head (LLaMA convention). Built on `device` with seeded
    random weights (`seed=None` leaves them uninitialised, for
    `load_state_dict`)."""

    def __init__(self, cfg: LlamaConfig, *, device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}")
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, bias=False)
        if seed is not None:
            init_random_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.lm_head(h)

    def _embed_step(self, token_ids: torch.Tensor, position):
        """A decode step's embedding (in the parameters' type: no cast) and
        its rotary tables, (N|1, 1, 1, D) each, broadcasting over (N, H, 1,
        D)."""
        position = torch.as_tensor(position, device=token_ids.device)
        pos = self._decode_pos(position)[..., 0]  # () -> (1,), (N,) -> (N,)
        cos, sin = rope_cos_sin(pos, self.cfg.head_dim, self.cfg.rope_theta)
        return self.model.embed_tokens(token_ids), (cos[:, None, None], sin[:, None, None])

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
        entropy through `lm_head` and `logits` is None."""
        h, hidden_states, captures, aux_loss = self.model(
            input_ids, attention_mask_1d, teacher_outputs, benchmarking=benchmarking,
            training=training, jitter=jitter, output_hidden_states=output_hidden_states,
            output_captures=output_captures,
        )
        logits, loss = lm_loss(self, h, labels, logit_chunk)
        return {"logits": logits, "loss": loss, "hidden_states": hidden_states,
                "teacher_captures": captures, "aux_loss": aux_loss}


# the port's causal LMs, which the trainers take alike
CausalLM = Union[OptForCausalLM, LlamaForCausalLM]
