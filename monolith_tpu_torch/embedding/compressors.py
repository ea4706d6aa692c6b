"""Serving-side embedding compressors (the port's copy; numpy only).

Fp32 / Fp16 / FixedR8 / OneBit compress a segment's rows for a serving
export; `ServingModel` decompresses them at load. The quantized formats
store a scale factor per row. Bit for bit the JAX package's compressors, so
an export written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str = "fp32"

    def compress(self, rows: np.ndarray) -> dict:
        raise NotImplementedError

    def decompress(self, blob: dict) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Fp32(Compressor):
    name: str = "fp32"

    def compress(self, rows):
        return {"data": np.asarray(rows, dtype=np.float32)}

    def decompress(self, blob):
        return blob["data"].astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Fp16(Compressor):
    name: str = "fp16"

    def compress(self, rows):
        return {"data": np.asarray(rows, dtype=np.float16)}

    def decompress(self, blob):
        return blob["data"].astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FixedR8(Compressor):
    """8-bit fixed-range quantization with a per-row scale."""
    name: str = "fixed_r8"

    def compress(self, rows):
        rows = np.asarray(rows, dtype=np.float32)
        scale = np.maximum(np.abs(rows).max(axis=-1, keepdims=True), 1e-12) / 127.0
        q = np.clip(np.round(rows / scale), -127, 127).astype(np.int8)
        return {"data": q, "scale": scale.astype(np.float32)}

    def decompress(self, blob):
        return blob["data"].astype(np.float32) * blob["scale"]


@dataclasses.dataclass(frozen=True)
class OneBit(Compressor):
    """Sign + per-row magnitude."""
    name: str = "one_bit"

    def compress(self, rows):
        rows = np.asarray(rows, dtype=np.float32)
        mag = np.abs(rows).mean(axis=-1, keepdims=True).astype(np.float32)
        bits = np.packbits(rows >= 0, axis=-1)
        return {"data": bits, "scale": mag, "dim": np.int32(rows.shape[-1])}

    def decompress(self, blob):
        dim = int(blob["dim"])
        signs = np.unpackbits(blob["data"], axis=-1)[..., :dim].astype(np.float32)
        return (signs * 2.0 - 1.0) * blob["scale"]


NAMED_COMPRESSORS = {
    "fp32": Fp32,
    "fp16": Fp16,
    "fixed_r8": FixedR8,
    "one_bit": OneBit,
}
