"""Dynamic quantisation and the seed hash, on numpy arrays (the host index
build) and on tensors (the device sketch); port of
rawhash_tpu/sketch/quantize.py.

u32 values ride in int64 with explicit 32-bit masks on tensors: PyTorch has
no shifts on uint32 tensors on every device, and int64 holds every u32
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def dynamic_quantize_np(
    signal: np.ndarray,
    fine_min: float,
    fine_max: float,
    fine_range: float,
    n_buckets: int,
) -> np.ndarray:
    """Vectorized dynamic quantization (numpy). Returns int32 codes; callers
    mask with (n_buckets - 1)."""
    sig = np.asarray(signal, dtype=np.float32)
    min_val, max_val = np.float32(-3.0), np.float32(3.0)
    rng = max_val - min_val
    coarse1 = np.float32((1.0 - fine_range) / 2.0)
    coarse2 = np.float32(fine_range) + coarse1
    normalized = (sig - min_val) / rng
    a = (np.float32(fine_min) - min_val) / rng
    b = (np.float32(fine_max) - min_val) / rng
    fine = np.float32(fine_range) * ((normalized - a) / (b - a))
    coarse = np.where(
        normalized < 0.5,
        np.float32(fine_range) + coarse1 * normalized,
        coarse2 + coarse1 * normalized,
    )
    quantized = np.where((sig >= fine_min) & (sig <= fine_max), fine, coarse)
    scaled = quantized * np.float32(n_buckets - 1)
    return np.trunc(scaled).astype(np.int64).astype(np.int32)


def hash32_np(key: np.ndarray) -> np.ndarray:
    """32-bit invertible mixing hash (reference: hash64 with mask=(1<<32)-1,
    src/rsketch.c:7-16).  Input/output uint32."""
    key = np.asarray(key, dtype=np.uint32)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint32(21)))
        key = key ^ (key >> np.uint32(24))
        key = (key + (key << np.uint32(3))) + (key << np.uint32(8))
        key = key ^ (key >> np.uint32(14))
        key = (key + (key << np.uint32(2))) + (key << np.uint32(4))
        key = key ^ (key >> np.uint32(28))
        key = key + (key << np.uint32(31))
    return key


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
