"""Immutable configuration for SEA attention (PyTorch port).

The port's own copy of `sea_tpu/config.py`: the same frozen dataclass, the
same field names, defaults and `validate()`, so a configuration written for
one package reads the same in the other. Fields that only steer the JAX
compiler or the TPU kernels (`use_pallas`, `block_q`, `max_nnz`) keep their
names; the port reads `block_q` as the q-block size of the tile lists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SeaConfig:
    """Static configuration of a SEA (perlin) attention module."""

    # --- core attention geometry -------------------------------------------------
    num_heads: int = 12
    head_dim: int = 64
    # compressed predictor width T_M
    predictor_length: int = 128
    # per-query retained budget k
    k: int = 7
    k_oversample: float = 1.0
    # 'causal_batch' | 'batch' | 'head' | 'query'
    k_flatten_dim: str = "causal_batch"
    causal: bool = False

    # --- predictor ----------------------------------------------------------------
    # 'mlp' | 'comp'
    predictor_method: str = "mlp"
    # 'performer' | 'cosformer'
    predictor_backend: str = "performer"
    performer_nb_factor: int = 1
    enc_per_layer: bool = False
    # channel splits feeding the CNN (4 non-causal, 2 causal when None)
    dec_row_splits: Optional[int] = None
    # codebook predictor ('comp') knobs
    comp_book_size: int = 8
    comp_patch_size: int = 16
    comp_patch_count: int = 16
    # deeper 3-conv causal CNN stack
    cnn_deeper: bool = False
    # run the causal predictor CNN in row chunks of this size (0 = whole T);
    # overlap-discard chunking is exact because each dilated causal conv
    # looks back 4 rows
    cnn_row_chunk: int = 0
    # distill against the student's own detached dense scores
    kd_self_teacher: bool = False

    # --- output mixing --------------------------------------------------------
    partial_attention_scaler: bool = True
    context_output_method: str = "mix"  # 'mix' | 'norm'
    out_norm: bool = False
    out_add_performer_context: bool = False

    # --- lora / layerwise -----------------------------------------------------
    lora_enabled: bool = False
    lora_in_approx_enabled: bool = False
    lora_r: int = 32
    layerwise: bool = False

    # --- decode cache ---------------------------------------------------------
    use_cache: bool = False

    # --- runtime-k override ---------------------------------------------------
    dynamic_k: int = 0
    # predictor query subsampling
    query_skips: int = 1

    # --- sequence / kernel knobs ----------------------------------------------
    # max sequence for the learned causal identity-value embedding
    max_position_embeddings: int = 2048
    # static nnz budget per query row of the uniform-CSR path (None = derived)
    max_nnz: Optional[int] = None
    # q-block size of the fused kernel's tile lists; None = the kernel's tile
    block_q: Optional[int] = None
    # benchmark path through the fused sparse kernel
    use_pallas: bool = True
    # task-only training through the differentiable fused kernel
    use_fused_train: bool = False

    @property
    def effective_k(self) -> int:
        return self.dynamic_k if self.dynamic_k > 0 else self.k

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def nb_features(self) -> int:
        """FAVOR+ feature count."""
        d = self.head_dim
        return int(d * math.log(d) / self.performer_nb_factor)

    @property
    def splits(self) -> int:
        if self.dec_row_splits is not None:
            return self.dec_row_splits
        return 2 if self.causal else 4

    @property
    def dec_row_down_scale(self) -> int:
        return 4 if self.causal else 2

    def max_nnz_for(self, t_src: int) -> int:
        """Static per-row nnz budget of the uniform CSR mask."""
        if self.max_nnz is not None:
            return self.max_nnz
        k = math.ceil(self.effective_k * self.k_oversample)
        t_m = self.predictor_length
        raw = self.num_heads * max(
            math.ceil(math.sqrt(k * t_m)) + 1,
            2 * k + math.ceil(t_src / t_m) + 1,
        )
        return ((raw + 127) // 128) * 128

    def validate(self) -> "SeaConfig":
        if self.causal:
            assert self.k_flatten_dim == "causal_batch", (
                "causal SEA requires k_flatten_dim='causal_batch'"
            )
        assert self.predictor_method in ("mlp", "comp")
        assert self.predictor_backend in ("performer", "cosformer")
        assert self.context_output_method in ("mix", "norm")
        assert self.k_flatten_dim in ("causal_batch", "batch", "head", "query")
        if self.out_add_performer_context:
            raise ValueError(
                "out_add_performer_context is rejected: the performer context "
                "carries 2*D channels (identity ‖ v) and cannot be residually "
                "added"
            )
        return self


def opt_config(**kw) -> SeaConfig:
    """The canonical causal OPT configuration (H=12, D=64, T_M=256, k=64,
    performer factor 8)."""
    base = dict(
        num_heads=12,
        head_dim=64,
        predictor_length=256,
        k=64,
        performer_nb_factor=8,
        causal=True,
        k_flatten_dim="causal_batch",
        max_position_embeddings=2048,
    )
    base.update(kw)
    return SeaConfig(**base).validate()


def bert_config(**kw) -> SeaConfig:
    """The canonical non-causal BERT configuration (H=12, D=64, T_M=128,
    k=64, performer factor 1)."""
    base = dict(
        num_heads=12,
        head_dim=64,
        predictor_length=128,
        k=64,
        performer_nb_factor=1,
        causal=False,
        k_flatten_dim="causal_batch",
    )
    base.update(kw)
    return SeaConfig(**base).validate()
