"""FAVOR+ kernel linear attention (Performer), PyTorch port.

Port of `sea_tpu/ops/performer.py`:

  * softmax random features with q/k max-stabilisation (non-causal),
  * generalized ReLU features (causal / OPT),
  * the Gaussian-orthogonal random projection, drawn from an explicit
    `torch.Generator`,
  * causal prefix linear attention in chunks: a running (M, Dv) state for
    the flow between chunks and a small causal-masked dense product inside
    each chunk, the same arithmetic as the JAX scan;
  * `redraw_projections`, the trainers' periodic redraw of every module's
    projection.

Everything is computed in float32 whatever the caller's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def gaussian_orthogonal_random_matrix(
    generator: torch.Generator,
    nb_rows: int,
    nb_cols: int,
    scaling: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Orthogonal random feature projection: orthonormal blocks scaled by
    chi-distributed norms (scaling=0), so that marginals match an iid
    Gaussian matrix. Drawn on the generator's device, returned on `device`."""
    gen_device = generator.device
    n_full = nb_rows // nb_cols
    blocks = []

    def normal(shape):
        return torch.randn(shape, generator=generator, device=gen_device,
                           dtype=torch.float32)

    for _ in range(n_full):
        q, _ = torch.linalg.qr(normal((nb_cols, nb_cols)))
        blocks.append(q.T)
    rem = nb_rows - n_full * nb_cols
    if rem > 0:
        q, _ = torch.linalg.qr(normal((nb_cols, nb_cols)))
        blocks.append(q.T[:rem])
    mat = torch.cat(blocks, dim=0)
    if scaling == 0:
        mult = torch.linalg.norm(normal((nb_rows, nb_cols)), dim=-1)
    elif scaling == 1:
        mult = torch.full((nb_rows,), math.sqrt(nb_cols), dtype=torch.float32,
                          device=gen_device)
    else:
        raise ValueError(scaling)
    return (mult[:, None] * mat).to(device)


def softmax_kernel_features(
    x: torch.Tensor, proj: torch.Tensor, is_query: bool, eps: float = 1e-4
) -> torch.Tensor:
    """phi(x) = m^-1/2 (exp(w·x̂ - |x̂|²/2 - stab) + eps), x̂ = x/d^(1/4).

    Queries stabilise per position (max over features), keys per
    (batch, head) (max over features and positions)."""
    x = x.float()
    d = x.shape[-1]
    m = proj.shape[0]
    data_normalizer = d ** -0.25
    ratio = m ** -0.5
    wx = torch.einsum("...td,md->...tm", data_normalizer * x, proj)
    diag = torch.sum(x * x, dim=-1, keepdim=True) / 2.0 * (data_normalizer ** 2)
    if is_query:
        stab = torch.amax(wx, dim=-1, keepdim=True).detach()
    else:
        stab = torch.amax(wx, dim=(-1, -2), keepdim=True).detach()
    return ratio * (torch.exp(wx - diag - stab) + eps)


def relu_kernel_features(
    x: torch.Tensor, proj: Optional[torch.Tensor], eps: float = 1e-3
) -> torch.Tensor:
    """Generalized-attention features: relu(w·x̂) + eps."""
    x = x.float()
    d = x.shape[-1]
    data_normalizer = d ** -0.25
    if proj is None:
        return torch.relu(data_normalizer * x) + eps
    wx = torch.einsum("...td,md->...tm", data_normalizer * x, proj)
    return torch.relu(wx) + eps


def linear_attention_noncausal(
    qp: torch.Tensor, kp: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """out = D^-1 Q'(K'^T V), D = diag(Q'(K'^T 1))."""
    v = v.float()
    k_sum = kp.sum(dim=-2)
    d_inv = 1.0 / torch.einsum("...tm,...m->...t", qp, k_sum)
    context = torch.einsum("...sm,...sd->...md", kp, v)
    return torch.einsum("...md,...tm,...t->...td", context, qp, d_inv)


def causal_linear_attention(
    qp: torch.Tensor,
    kp: torch.Tensor,
    v: torch.Tensor,
    chunk: int = 128,
    eps: float = 1e-6,
) -> torch.Tensor:
    """out_t = (q'_t · C_t) / (q'_t · (s_t + eps)), with prefix sums
    C_t = sum_{s<=t} k'_s v_s^T and s_t = sum_{s<=t} k'_s, in chunks of
    `chunk` rows. T is zero-padded to a whole chunk; padding rows have
    den <= 0, which is replaced by 1 before the division."""
    qp, kp, v = qp.float(), kp.float(), v.float()
    *batch, T, M = qp.shape
    Dv = v.shape[-1]

    pad = (-T) % chunk
    if pad:
        qp = torch.nn.functional.pad(qp, (0, 0, 0, pad))
        kp = torch.nn.functional.pad(kp, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    nc = (T + pad) // chunk

    S = torch.zeros((*batch, M, Dv), dtype=torch.float32, device=qp.device)
    z = torch.zeros((*batch, M), dtype=torch.float32, device=qp.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=qp.device))
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        q_i, k_i, v_i = qp[..., sl, :], kp[..., sl, :], v[..., sl, :]
        a = torch.einsum("...tm,...sm->...ts", q_i, k_i) * tri
        num = torch.einsum("...ts,...sd->...td", a, v_i) + torch.einsum(
            "...tm,...md->...td", q_i, S
        )
        den = (
            a.sum(dim=-1)
            + torch.einsum("...tm,...m->...t", q_i, z)
            + eps * q_i.sum(dim=-1)
        )
        den = torch.where(den <= 0, torch.ones_like(den), den)
        outs.append(num / den[..., None])
        S = S + torch.einsum("...sm,...sd->...md", k_i, v_i)
        z = z + k_i.sum(dim=-2)
    return torch.cat(outs, dim=-2)[..., :T, :]


def fast_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    proj: torch.Tensor,
    causal: bool,
    generalized: bool,
    chunk: int = 128,
) -> torch.Tensor:
    """Featurize, then apply (non-)causal linear attention. Output float32,
    shape (..., T, Dv)."""
    if generalized:
        qp = relu_kernel_features(q, proj)
        kp = relu_kernel_features(k, proj)
    else:
        qp = softmax_kernel_features(q, proj, is_query=True)
        kp = softmax_kernel_features(k, proj, is_query=False)
    if causal:
        return causal_linear_attention(qp, kp, v, chunk=chunk)
    return linear_attention_noncausal(qp, kp, v.float())


def redraw_projections(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Redraw every FAVOR+ projection buffer (`performer_proj`) under `model`
    in place from `generator`, in module order: the trainers' periodic
    feature redraw. The buffers are never trained."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.rsplit(".", 1)[-1] == "performer_proj":
                buf.copy_(gaussian_orthogonal_random_matrix(
                    generator, buf.shape[0], buf.shape[1], device=buf.device))
