"""The 4-bit GEMV probe's plain version (ops/w4_gemv_probe.py) against the
probe's own integer reference in tools/exp_w4_gemv.py: the same numpy
draws, packed as its main() packs them (:125), and want = sum_l x @ W_l in
int64 (:145-148). The kernel itself runs on the card only
(chip_smoke.check_w4_gemv_probe holds it to this plain version exactly)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe


def _draw(L, K, N, seed):
    """x and the weights as exp_w4_gemv.main() draws them, and the packed
    bytes of its split-half layout."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (1, K)).astype(np.int8)
    wv = rng.integers(-8, 8, (L, K, N)).astype(np.int32)
    packed = ((wv[:, :K // 2] + 8) | ((wv[:, K // 2:] + 8) << 4)).astype(np.uint8)
    want = np.zeros((1, N), np.int64)
    for l in range(L):
        want += np.asarray(x, np.int64) @ wv[l].astype(np.int64)
    return x, wv, packed, want


@pytest.mark.parametrize("L,K,N", [(3, 16, 8), (28, 64, 12)])
@pytest.mark.parametrize("variant", ["int8", "packed"])
def test_plain_probe_equals_the_integer_reference(L, K, N, variant):
    x, wv, packed, want = _draw(L, K, N, seed=L * K + N)
    if variant == "packed":
        w = torch.from_numpy(packed.view(np.int8))
        np.testing.assert_array_equal(probe.pack_nibbles(torch.from_numpy(wv)).numpy(),
                                      packed.view(np.int8))
    else:
        w = torch.from_numpy(wv.astype(np.int8))
    got = probe.w4_gemv_probe(torch.from_numpy(x), w, variant == "packed")
    assert got.dtype == torch.int32 and got.shape == (1, N)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_probe_rejects_mismatched_shapes():
    x = torch.zeros((1, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="K/2"):
        probe.w4_gemv_probe(x, torch.zeros((2, 16, 8), dtype=torch.int8), True)
    with pytest.raises(ValueError, match="int8"):
        probe.w4_gemv_probe(x.float(), torch.zeros((2, 16, 8), dtype=torch.int8), False)
