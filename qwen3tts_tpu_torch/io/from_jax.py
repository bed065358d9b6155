"""The weight seam from the JAX package into the port.

Input: the JAX package's ``TalkerParams``, ``CodePredictorParams``,
``VocoderParams`` or ``SpeakerEncoderParams`` with numpy leaves — the caller runs
``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side, so this
module never imports jax. The NamedTuples are read by field name and rebuilt
as the port's NamedTuples of the same names; quantized leaves (int8
``QuantLinear``, u4 ``QuantLinear4``) carry ``q``, ``scale`` and ``zero``
across unchanged (nothing is re-quantized), and plain bf16 ``[L, K, N]``
leaves cross as they are. numpy arrays of ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, cross as a uint16 view reinterpreted as
``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import code_predictor, speaker_encoder, talker, transformer_core, vocoder
from ..ops import quant

_PORT_TYPES = {
    cls.__name__: cls for cls in (
        talker.TalkerParams, code_predictor.CodePredictorParams,
        transformer_core.BlockParams, quant.QuantLinear, quant.QuantLinear4,
        vocoder.VocoderParams,
        vocoder.PreTfmBlockParams, vocoder.ConvNeXtParams, vocoder.ResBlockParams,
        vocoder.DecoderBlockParams, speaker_encoder.SEResBlockParams,
        speaker_encoder.SpeakerEncoderParams)
}


def array_to_torch(a, device="cpu") -> torch.Tensor:
    """numpy array (bfloat16 included) -> torch tensor on `device` (a copy:
    arrays from JAX are read-only)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device="cpu"):
    """Rebuild a JAX-package params tree (NamedTuples / tuples of numpy
    arrays) as the port's, field by field."""
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        name = type(tree).__name__
        if name not in _PORT_TYPES:
            raise TypeError(f"no port counterpart for params type {name}")
        port = _PORT_TYPES[name]
        if tuple(port._fields) != tuple(fields):
            raise TypeError(f"{name}: fields {fields} differ from the port's {port._fields}")
        return port(*(params_from_jax(getattr(tree, f), device) for f in fields))
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(t, device) for t in tree)
    return array_to_torch(tree, device)
