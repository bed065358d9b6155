"""The WavTokenizer-style codec vocoder: 16-codebook codes -> 24 kHz audio
(counterpart of ``qwen3tts_tpu/models/vocoder.py``).

VQ dequant -> causal pre-conv k=3 -> 8-layer causal pre-transformer (RoPE
theta 1e4, LayerScale, SwiGLU) -> 2 ConvNeXt x2 upsample blocks -> causal
conv k=7 -> 4 decoder blocks [Snake -> ConvT x8/5/4/3 -> 3 residual blocks
d=1/3/9] -> Snake -> causal conv k=7 -> tanh; 1920 samples per frame.

Everything is plain float32 PyTorch except the residual blocks, which run
kernel K3 (``ops/fused_vocoder.fused_res_block``). Activations are
[B, T, C], a group of lanes (the counterpart of the JAX package's
``_vocode_batch``, which maps ``vocoder_forward`` over lanes), or [T, C],
one clip, which the stages treat as a group of one: every stage pads
causally per lane, and the pre-transformer masks each lane's keys at its
frame count. Lanes are
right-padded to the group's longest; the stack is causal, so a lane's
valid samples do not depend on the padding. Conv weights are [K, In, Out];
transposed-conv weights are pre-flipped [K, In, Out] (the JAX layouts).
The JAX package pads the 96- and 192-channel decoder blocks to 128 lanes
for its TPU kernel; the port does not. Transposed
convs trim causally by default (``trim="causal"``, the Python ground truth
every serve path uses); ``trim="symmetric"`` is the C++ reference's
variant, as in the JAX package (``vocoder.py:96-150``): each transposed
conv also drops K - stride rows at the left.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from ..ops.fused_vocoder import conv1d_causal, fused_res_block, snake
from ..ops.norms import layer_norm, rms_norm
from ..ops.precision import full_float32
from ..ops.rope import apply_rope, rope_for_positions

NEG_INF = -1e30


class PreTfmBlockParams(NamedTuple):
    """Stacked x n_pre_tfm_layers."""
    attn_norm: torch.Tensor   # [L, W]
    wq: torch.Tensor          # [L, W, Q]
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor          # [L, Q, W]
    attn_scale: torch.Tensor  # [L, W] LayerScale
    ffn_norm: torch.Tensor
    w_gate: torch.Tensor      # [L, W, F]
    w_up: torch.Tensor
    w_down: torch.Tensor      # [L, F, W]
    ffn_scale: torch.Tensor


class ConvNeXtParams(NamedTuple):
    """Stacked x 2."""
    convt_w: torch.Tensor     # [2, 2, C, C]
    convt_b: torch.Tensor     # [2, C]
    dw_w: torch.Tensor        # [2, 7, 1, C]
    dw_b: torch.Tensor
    ln_w: torch.Tensor
    ln_b: torch.Tensor
    pw1_w: torch.Tensor       # [2, C, M]
    pw1_b: torch.Tensor
    pw2_w: torch.Tensor       # [2, M, C]
    pw2_b: torch.Tensor
    gamma: torch.Tensor


class ResBlockParams(NamedTuple):
    """Stacked x 3 (dilations 1/3/9) within one decoder block."""
    act1_alpha: torch.Tensor  # [3, C]
    act1_beta: torch.Tensor
    conv1_w: torch.Tensor     # [3, 7, C, C]
    conv1_b: torch.Tensor
    act2_alpha: torch.Tensor
    act2_beta: torch.Tensor
    conv2_w: torch.Tensor     # [3, 1, C, C]
    conv2_b: torch.Tensor


class DecoderBlockParams(NamedTuple):
    snake_alpha: torch.Tensor  # [Cin]
    snake_beta: torch.Tensor
    convt_w: torch.Tensor      # [2r, Cin, Cout]
    convt_b: torch.Tensor      # [Cout]
    res: ResBlockParams


class VocoderParams(NamedTuple):
    vq_first_cb: torch.Tensor     # [Vcb, 256]
    vq_rest_cb: torch.Tensor      # [15, Vcb, 256]
    vq_first_proj: torch.Tensor   # [256, 512]
    vq_rest_proj: torch.Tensor
    pre_conv_w: torch.Tensor      # [3, 512, 1024]
    pre_conv_b: torch.Tensor
    pt_in_w: torch.Tensor         # [1024, 512]
    pt_in_b: torch.Tensor
    pt_blocks: PreTfmBlockParams
    pt_norm: torch.Tensor
    pt_out_w: torch.Tensor        # [512, 1024]
    pt_out_b: torch.Tensor
    convnext: ConvNeXtParams
    dec0_w: torch.Tensor          # [7, 1024, 1536]
    dec0_b: torch.Tensor
    dec_blocks: tuple             # 4 x DecoderBlockParams
    final_alpha: torch.Tensor     # [96]
    final_beta: torch.Tensor
    out_w: torch.Tensor           # [7, 96, 1]
    out_b: torch.Tensor           # [1]


def init_vocoder_params(gen: torch.Generator, cfg, device="cpu") -> VocoderParams:
    """Synthetic float32 weights at the configured widths, drawn from `gen`."""
    f32 = torch.float32

    def w(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device, dtype=f32) / math.sqrt(fan_in)

    def full(shape, v):
        return torch.full(shape, v, dtype=f32, device=device)

    L, W, Q, F = cfg.n_pre_tfm_layers, cfg.pre_tfm_width, cfg.pre_tfm_qkv_dim, cfg.pre_tfm_ffn_dim
    C, M, N = cfg.latent_dim, cfg.convnext_mlp_dim, cfg.n_convnext
    pt = PreTfmBlockParams(
        attn_norm=full((L, W), 1.0), wq=w((L, W, Q), W), wk=w((L, W, Q), W),
        wv=w((L, W, Q), W), wo=w((L, Q, W), Q), attn_scale=full((L, W), 0.1),
        ffn_norm=full((L, W), 1.0), w_gate=w((L, W, F), W), w_up=w((L, W, F), W),
        w_down=w((L, F, W), F), ffn_scale=full((L, W), 0.1))
    cnx = ConvNeXtParams(
        convt_w=w((N, 2, C, C), 2 * C), convt_b=full((N, C), 0.0),
        dw_w=w((N, 7, 1, C), 7), dw_b=full((N, C), 0.0),
        ln_w=full((N, C), 1.0), ln_b=full((N, C), 0.0),
        pw1_w=w((N, C, M), C), pw1_b=full((N, M), 0.0),
        pw2_w=w((N, M, C), M), pw2_b=full((N, C), 0.0), gamma=full((N, C), 0.5))
    chans = cfg.decoder_channels
    dec = []
    for i, r in enumerate(cfg.upsample_rates):
        cin, cout = chans[i], chans[i + 1]
        dec.append(DecoderBlockParams(
            snake_alpha=full((cin,), 0.0), snake_beta=full((cin,), 0.0),
            convt_w=w((2 * r, cin, cout), 2 * r * cin), convt_b=full((cout,), 0.0),
            res=ResBlockParams(
                act1_alpha=full((3, cout), 0.0), act1_beta=full((3, cout), 0.0),
                conv1_w=w((3, 7, cout, cout), 7 * cout), conv1_b=full((3, cout), 0.0),
                act2_alpha=full((3, cout), 0.0), act2_beta=full((3, cout), 0.0),
                conv2_w=w((3, 1, cout, cout), cout), conv2_b=full((3, cout), 0.0))))
    return VocoderParams(
        vq_first_cb=w((cfg.codebook_size, cfg.codebook_dim), cfg.codebook_dim),
        vq_rest_cb=w((cfg.n_codebooks - 1, cfg.codebook_size, cfg.codebook_dim), cfg.codebook_dim),
        vq_first_proj=w((cfg.codebook_dim, cfg.hidden_dim), cfg.codebook_dim),
        vq_rest_proj=w((cfg.codebook_dim, cfg.hidden_dim), cfg.codebook_dim),
        pre_conv_w=w((3, cfg.hidden_dim, cfg.latent_dim), 3 * cfg.hidden_dim),
        pre_conv_b=full((cfg.latent_dim,), 0.0),
        pt_in_w=w((cfg.latent_dim, W), cfg.latent_dim), pt_in_b=full((W,), 0.0),
        pt_blocks=pt, pt_norm=full((W,), 1.0),
        pt_out_w=w((W, cfg.latent_dim), W), pt_out_b=full((cfg.latent_dim,), 0.0),
        convnext=cnx,
        dec0_w=w((7, cfg.latent_dim, cfg.decoder_dim), 7 * cfg.latent_dim),
        dec0_b=full((cfg.decoder_dim,), 0.0),
        dec_blocks=tuple(dec),
        final_alpha=full((chans[-1],), 0.0), final_beta=full((chans[-1],), 0.0),
        out_w=w((7, chans[-1], 1), 7 * chans[-1]), out_b=full((1,), 0.0))


TRIMS = ("causal", "symmetric")


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b, *, stride: int,
                     trim: str = "causal") -> torch.Tensor:
    """Transposed 1-D conv on x [..., T, Cin] with pre-flipped w [K, In, Out],
    K = J * stride, as J accumulated matmuls over all stride phases:
    y[q*s + p] = sum_j w[K-1-p-j*s] @ x[q-j]. The raw length T*s + (K-s) is
    trimmed by K-s: trim="causal" all from the right (T*s outputs);
    "symmetric" also K-s rows from the left (T*s - (K-s) outputs)."""
    K, cin, cout = w.shape
    s = stride
    if K % s:
        raise ValueError(f"transposed conv kernel {K} is not a multiple of stride {s}")
    if trim not in TRIMS:
        raise ValueError(f"trim must be one of {TRIMS}, got {trim!r}")
    J, T = K // s, x.shape[-2]
    w2 = w.flip(0).reshape(J, s, cin, cout).permute(0, 2, 1, 3).reshape(J, cin, s * cout)
    xp = Fn.pad(x, (0, 0, J - 1, 0))
    acc = torch.matmul(xp[..., J - 1:, :].float(), w2[0].float())
    for j in range(1, J):
        acc = acc + torch.matmul(xp[..., J - 1 - j: xp.shape[-2] - j, :].float(),
                                 w2[j].float())
    y = acc.to(x.dtype).reshape(*x.shape[:-2], T * s, cout)
    if trim == "symmetric":
        y = y[..., K - s:, :]
    return y if b is None else y + b


def depthwise_conv1d_causal(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """Causal depthwise conv on x [..., T, C] with w [K, 1, C]."""
    K, T = w.shape[0], x.shape[-2]
    xp = Fn.pad(x, (0, 0, K - 1, 0))
    y = xp[..., 0:T, :] * w[0, 0]
    for k in range(1, K):
        y = y + xp[..., k:k + T, :] * w[k, 0]
    return y + b


def _pre_transformer(params: VocoderParams, cfg, x: torch.Tensor, n_valid) -> torch.Tensor:
    """Causal MHA transformer on a group of lanes [B, T, W] (a clip [T, W]
    runs as a group of one): lane b's keys from n_valid[b] on are masked
    (none when n_valid is None). A lane's rows past its frame count see its
    valid keys only; the stack is causal, so no valid row reads them."""
    if x.dim() == 2:
        return _pre_transformer(params, cfg, x[None], n_valid)[0]
    T = x.shape[-2]
    Hn = cfg.n_heads
    D = cfg.pre_tfm_qkv_dim // Hn
    eps = cfg.rms_norm_eps
    pos = torch.arange(T, device=x.device)
    cos, sin = rope_for_positions(pos, D, cfg.rope_theta)
    mask = (pos[None, :] <= pos[:, None])[None]
    if isinstance(n_valid, torch.Tensor):
        # counts on the device (an exported program's operand)
        mask = mask & (pos < n_valid.to(pos.device).reshape(-1, 1))[:, None, :]
    elif n_valid is not None:
        # from the host's counts on the device, with no copy to wait for
        keys = torch.stack([pos < n for n in torch.as_tensor(n_valid).reshape(-1).tolist()])
        mask = mask & keys[:, None, :]
    heads = x.shape[:-1] + (Hn, D)
    p = params.pt_blocks
    for l in range(p.attn_norm.shape[0]):
        h = rms_norm(x, p.attn_norm[l], eps)
        q = apply_rope((h @ p.wq[l]).reshape(heads), cos, sin)
        k = apply_rope((h @ p.wk[l]).reshape(heads), cos, sin)
        v = (h @ p.wv[l]).reshape(heads)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (D ** 0.5)
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(x.shape[:-1] + (Hn * D,))
        x = x + (o @ p.wo[l]) * p.attn_scale[l]
        h = rms_norm(x, p.ffn_norm[l], eps)
        gate = Fn.silu((h @ p.w_gate[l]).float()).to(h.dtype)
        x = x + ((gate * (h @ p.w_up[l])) @ p.w_down[l]) * p.ffn_scale[l]
    return x


def _convnext_block(x: torch.Tensor, p: ConvNeXtParams, i: int,
                    trim: str = "causal") -> torch.Tensor:
    x = conv_transpose1d(x, p.convt_w[i], p.convt_b[i], stride=2, trim=trim)
    residual = x
    x = depthwise_conv1d_causal(x, p.dw_w[i], p.dw_b[i])
    x = layer_norm(x, p.ln_w[i], p.ln_b[i], 1e-6)
    x = x @ p.pw1_w[i] + p.pw1_b[i]
    x = Fn.gelu(x.float(), approximate="none").to(x.dtype)
    x = x @ p.pw2_w[i] + p.pw2_b[i]
    return residual + x * p.gamma[i]


def _residual_block(x: torch.Tensor, res: ResBlockParams, i: int, dilation: int) -> torch.Tensor:
    return fused_res_block(x, res.conv1_w[i], res.conv1_b[i], res.act1_alpha[i],
                           res.act1_beta[i], res.conv2_w[i], res.conv2_b[i],
                           res.act2_alpha[i], res.act2_beta[i], dilation=dilation)


def _decoder_block(x: torch.Tensor, blk: DecoderBlockParams, rate: int,
                   dilations, trim: str = "causal") -> torch.Tensor:
    x = snake(x, blk.snake_alpha, blk.snake_beta)
    x = conv_transpose1d(x, blk.convt_w, blk.convt_b, stride=rate, trim=trim)
    for i, d in enumerate(dilations):
        x = _residual_block(x, blk.res, i, d)
    return x


def vocoder_forward(params: VocoderParams, cfg, codes: torch.Tensor,
                    n_frames=None, *, trim: str = "causal") -> torch.Tensor:
    """Decode codes [T, 16] (int) to a waveform [T * 1920] in [-1, 1]; or a
    group of lanes, codes [B, T, 16] with n_frames [B] (each lane's frame
    count; rows past it are padding), to [B, T * 1920], whose lane b holds
    lane b's waveform in its first n_frames[b] * 1920 samples. With
    trim="symmetric" each transposed conv drops its K - stride rows at
    both ends (conv_transpose1d), so a clip is shorter than T * 1920."""
    codes = codes.to(device=params.vq_first_cb.device, dtype=torch.int64)
    first = params.vq_first_cb[codes[..., 0]]
    steps = torch.arange(cfg.n_codebooks - 1, device=codes.device)
    rest = params.vq_rest_cb[steps, codes[..., 1:]]
    latent = first @ params.vq_first_proj + torch.sum(rest, dim=-2) @ params.vq_rest_proj
    x = conv1d_causal(latent, params.pre_conv_w, params.pre_conv_b)
    x = x @ params.pt_in_w + params.pt_in_b
    x = _pre_transformer(params, cfg, x, n_frames)
    x = rms_norm(x, params.pt_norm, cfg.rms_norm_eps)
    x = x @ params.pt_out_w + params.pt_out_b
    for i in range(cfg.n_convnext):
        x = _convnext_block(x, params.convnext, i, trim)
    x = conv1d_causal(x, params.dec0_w, params.dec0_b)
    for blk, rate in zip(params.dec_blocks, cfg.upsample_rates):
        x = _decoder_block(x, blk, rate, cfg.res_dilations, trim)
    x = snake(x, params.final_alpha, params.final_beta)
    x = conv1d_causal(x, params.out_w, params.out_b)
    return torch.tanh(x.float())[..., 0]


def vocoder_decode(params: VocoderParams, cfg, codes: torch.Tensor,
                   n_frames=None, *, trim: str = "causal") -> torch.Tensor:
    """vocoder_forward with TF32 off for the call (``ops/precision.py``): the
    plain float32 stages must run in full float32 on the card, as the XLA
    reference does."""
    with full_float32(), torch.no_grad():
        return vocoder_forward(params, cfg, codes, n_frames, trim=trim)
