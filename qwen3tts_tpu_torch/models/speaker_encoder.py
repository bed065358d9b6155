"""ECAPA-TDNN speaker encoder: log-mel -> x-vector for voice cloning
(counterpart of ``qwen3tts_tpu/models/speaker_encoder.py``).

Reference component #4 (SURVEY.md §2; src/audio_tokenizer_encoder.cpp
:445-701):

  conv k=5 (reflect pad) 128->512 + ReLU
  3 x SE-Res2Net blocks (scale 8, dilations 2/3/4):
      tdnn1 k=1 + ReLU -> res2net 8x64 hierarchical k=3 dilated convs with
      reflect padding + ReLU -> tdnn2 k=1 + ReLU -> squeeze-excitation
      (mean over time -> 128 -> sigmoid 512 scale) -> + residual
  MFA concat(block1..3) 1536 -> k=1 conv + ReLU
  attentive-statistics pooling: concat[x, global mean, global std] 4608 ->
      tdnn k=1 128 + ReLU -> tanh -> conv k=1 1536 -> softmax over time ->
      weighted mean/std -> concat 3072
  fc k=1 3072 -> 1024

Plain float32 PyTorch (the JAX package has no Pallas kernel here): k=1
convs are matmuls, the k=3/5 convs ``conv1d`` over an input padded by the
JAX package's reflection indices (``_reflect_idx``, which, unlike
``F.pad(mode="reflect")``, also covers a pad that reaches n). The port runs
on exactly the request's n frames, so nothing is masked: the JAX package's
frame buckets are compile-cache keys. ``speaker_embedding`` runs the mel
front end and the network with TF32 off (``ops/precision.py``).
Weights: k-tap convs [K, in, out] (the JAX layout).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from ..audio import mel as mel_mod
from ..ops.precision import full_float32
from .transformer_core import normal_init


class SEResBlockParams(NamedTuple):
    tdnn1_w: torch.Tensor    # [1, C, C]
    tdnn1_b: torch.Tensor
    res2net_w: torch.Tensor  # [scale-1, 3, B, B]
    res2net_b: torch.Tensor  # [scale-1, B]
    tdnn2_w: torch.Tensor    # [1, C, C]
    tdnn2_b: torch.Tensor
    se1_w: torch.Tensor      # [1, C, S]
    se1_b: torch.Tensor
    se2_w: torch.Tensor      # [1, S, C]
    se2_b: torch.Tensor


class SpeakerEncoderParams(NamedTuple):
    conv0_w: torch.Tensor    # [5, n_mels, C]
    conv0_b: torch.Tensor
    blocks: tuple            # 3 x SEResBlockParams
    mfa_w: torch.Tensor      # [1, 3C, 3C]
    mfa_b: torch.Tensor
    asp_tdnn_w: torch.Tensor  # [1, 9C, A]
    asp_tdnn_b: torch.Tensor
    asp_conv_w: torch.Tensor  # [1, A, 3C]
    asp_conv_b: torch.Tensor
    fc_w: torch.Tensor        # [1, 6C, E]
    fc_b: torch.Tensor


def init_speaker_encoder_params(gen: torch.Generator, cfg, dtype=torch.float32,
                                device="cpu") -> SpeakerEncoderParams:
    """Synthetic weights at the configured widths, drawn from `gen` (a
    torch.Generator on `device`), zero biases."""
    w = normal_init(gen, device, dtype)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)   # noqa: E731
    C, B, S, A, M = cfg.hidden_dim, cfg.branch_dim, cfg.se_dim, cfg.attention_dim, cfg.mfa_dim
    blocks = tuple(
        SEResBlockParams(
            tdnn1_w=w((1, C, C), C), tdnn1_b=zeros(C),
            res2net_w=w((cfg.res2net_scale - 1, 3, B, B), 3 * B),
            res2net_b=zeros(cfg.res2net_scale - 1, B),
            tdnn2_w=w((1, C, C), C), tdnn2_b=zeros(C),
            se1_w=w((1, C, S), C), se1_b=zeros(S),
            se2_w=w((1, S, C), S), se2_b=zeros(C),
        )
        for _ in range(cfg.n_blocks)
    )
    return SpeakerEncoderParams(
        conv0_w=w((5, cfg.n_mels, C), 5 * cfg.n_mels), conv0_b=zeros(C),
        blocks=blocks,
        mfa_w=w((1, M, M), M), mfa_b=zeros(M),
        asp_tdnn_w=w((1, 3 * M, A), 3 * M), asp_tdnn_b=zeros(A),
        asp_conv_w=w((1, A, M), A), asp_conv_b=zeros(M),
        fc_w=w((1, 2 * M, cfg.embedding_dim), 2 * M), fc_b=zeros(cfg.embedding_dim),
    )


def _reflect_idx(t: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect positions t against [0, n) (same-pad reflect, torch style),
    as ``_reflect_idx`` of the JAX package (``speaker_encoder.py:91-96``)."""
    t = torch.where(t < 0, -t, t)
    t = torch.where(t >= n, 2 * n - 2 - t, t)
    return t.clamp(0, n - 1)


def _conv_reflect(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  dilation: int = 1) -> torch.Tensor:
    """'Same' conv on x [n, Cin] with w [K, Cin, Cout]: output t sums tap k
    at the reflected position t + k*dilation - pad."""
    K = w.shape[0]
    if K == 1:
        return x @ w[0] + b
    n = x.shape[0]
    pad = dilation * (K - 1) // 2
    src = _reflect_idx(torch.arange(-pad, n + pad, device=x.device), n)
    y = Fn.conv1d(x[src].T[None], w.permute(2, 1, 0), b, dilation=dilation)
    return y[0].T


def _mean_std(x: torch.Tensor, eps: float = 1e-12):
    """Mean/std over time, std as E[x^2]-E[x]^2 clamped, matching the
    reference (audio_tokenizer_encoder.cpp:615-629)."""
    mean = x.mean(dim=0)
    var = torch.clamp((x * x).mean(dim=0) - mean * mean, eps, 1e10)
    return mean, torch.sqrt(var)


def speaker_encoder_forward(params: SpeakerEncoderParams, cfg,
                            mel: torch.Tensor) -> torch.Tensor:
    """mel [n, n_mels] -> the speaker embedding [embedding_dim] (float32)."""
    B = cfg.branch_dim
    x = torch.relu(_conv_reflect(mel.float(), params.conv0_w, params.conv0_b))

    outputs = []
    for blk, dilation in zip(params.blocks, cfg.dilations):
        residual = x
        x = torch.relu(_conv_reflect(x, blk.tdnn1_w, blk.tdnn1_b))

        # Res2Net hierarchy: branch 0 passes through; branch i >= 1 convolves
        # (branch_i + out_{i-1}), except branch 1, which has no carry-in.
        branches = [x[:, i * B:(i + 1) * B] for i in range(cfg.res2net_scale)]
        outs = [branches[0]]
        for i in range(1, cfg.res2net_scale):
            inp = branches[i] if i == 1 else branches[i] + outs[-1]
            outs.append(torch.relu(_conv_reflect(inp, blk.res2net_w[i - 1],
                                                 blk.res2net_b[i - 1], dilation)))
        x = torch.cat(outs, dim=-1)
        x = torch.relu(_conv_reflect(x, blk.tdnn2_w, blk.tdnn2_b))

        # squeeze-excitation over time
        se = torch.relu(x.mean(dim=0) @ blk.se1_w[0] + blk.se1_b)
        se = torch.sigmoid(se @ blk.se2_w[0] + blk.se2_b)
        x = x * se[None, :] + residual
        outputs.append(x)

    x = torch.cat(outputs, dim=-1)                              # [n, 1536]
    x = torch.relu(_conv_reflect(x, params.mfa_w, params.mfa_b))

    # attentive statistics pooling
    gmean, gstd = _mean_std(x)
    att_in = torch.cat([x, gmean.expand_as(x), gstd.expand_as(x)], dim=-1)
    att = torch.tanh(torch.relu(att_in @ params.asp_tdnn_w[0] + params.asp_tdnn_b))
    att = torch.softmax(att @ params.asp_conv_w[0] + params.asp_conv_b, dim=0)

    wmean = (att * x).sum(dim=0)
    diff = x - wmean[None, :]
    wstd = torch.sqrt(torch.clamp((att * diff * diff).sum(dim=0), 1e-12, 1e10))
    pooled = torch.cat([wmean, wstd])                           # [3072]
    return (pooled @ params.fc_w[0] + params.fc_b).float()


def speaker_embedding(params: SpeakerEncoderParams, cfg, samples: torch.Tensor) -> torch.Tensor:
    """The x-vector of exactly len(samples) samples at cfg.sample_rate, on
    samples' device: log_mel then speaker_encoder_forward, in float32 with
    TF32 off."""
    fb = torch.from_numpy(mel_mod.slaney_mel_filterbank(cfg)).to(samples.device)
    win = torch.from_numpy(mel_mod.centered_hann(cfg)).to(samples.device)
    with full_float32(), torch.no_grad():
        return speaker_encoder_forward(params, cfg, mel_mod.log_mel(samples, cfg, fb, win))
