"""Dynamic quantisation and the seed hash on tensors (port of the `*_jnp`
halves of rawhash_tpu/sketch/quantize.py).

u32 values ride in int64 with explicit 32-bit masks: PyTorch has no shifts
on uint32 tensors on every device, and int64 holds every u32 exactly.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def dynamic_quantize(signal: torch.Tensor, fine_min: float, fine_max: float,
                     fine_range: float, n_buckets: int) -> torch.Tensor:
    """Elementwise dynamic quantisation (rsketch.c:18-53); f32 in, int32
    codes out (callers mask), with every constant rounded to f32 first."""
    f = np.float32
    sig = signal.to(torch.float32)
    min_val, max_val = f(-3.0), f(3.0)
    rng = max_val - min_val
    coarse1 = f((1.0 - fine_range) / 2.0)
    coarse2 = f(fine_range) + coarse1
    a = (f(fine_min) - min_val) / rng
    b = (f(fine_max) - min_val) / rng
    normalized = (sig - float(min_val)) / float(rng)
    fine = float(f(fine_range)) * ((normalized - float(a)) / float(b - a))
    coarse = torch.where(
        normalized < 0.5,
        float(f(fine_range)) + float(coarse1) * normalized,
        float(coarse2) + float(coarse1) * normalized,
    )
    in_fine = (sig >= float(f(fine_min))) & (sig <= float(f(fine_max)))
    quantized = torch.where(in_fine, fine, coarse)
    scaled = quantized * float(f(n_buckets - 1))
    return torch.trunc(scaled).to(torch.int32)


def hash32(key: torch.Tensor) -> torch.Tensor:
    """32-bit invertible mixing hash (rsketch.c:7-16 with a 32-bit mask),
    u32 values in and out, carried in int64."""
    key = key.to(torch.int64) & U32
    key = ((~key & U32) + ((key << 21) & U32)) & U32
    key = key ^ (key >> 24)
    key = (key + ((key << 3) & U32) + ((key << 8) & U32)) & U32
    key = key ^ (key >> 14)
    key = (key + ((key << 2) & U32) + ((key << 4) & U32)) & U32
    key = key ^ (key >> 28)
    return (key + ((key << 31) & U32)) & U32
