"""The arithmetic a reference runs in: float64, or the lower precision of
the control.

The paths the numbers check compute in float32 outside any matrix
library: kernels K1 and K2 are hand-written float32 CUDA, the 6x6 solve
and the pose-graph LM run in float32 on the host. TF32 (which
lis_slam_torch turns off at import) reaches none of them, so the step
below float32 that a later change would be tempted to take is bfloat16
storage: K2 is bound by the bytes of its points and neighbours.
`Numerics("bfloat16")` computes the reference so: every stored value
(points, neighbours, transformed points, node poses) rounded to
bfloat16, the arithmetic (products, sums, eigen-analyses, solves) in
float32. `Numerics("float64")` is the
reference itself.
"""

from __future__ import annotations

import numpy as np


def round_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    kept as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).copy()
    b = b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    return (b & np.uint32(0xFFFF0000)).view(np.float32)


class Numerics:
    def __init__(self, mode: str = "float64"):
        if mode not in ("float64", "bfloat16"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode
        self.dtype = np.float64 if mode == "float64" else np.float32

    def arr(self, x) -> np.ndarray:
        """A stored value in this precision."""
        x = np.asarray(x, dtype=self.dtype)
        return round_bf16(x) if self.mode == "bfloat16" else x

    def einsum(self, spec: str, *ops, store: bool = True) -> np.ndarray:
        """A product of stored values, summed in this precision's
        accumulator, and stored unless `store` is False (a sum that stays
        in the accumulator)."""
        out = np.einsum(spec, *(self.arr(o) for o in ops)).astype(self.dtype)
        return self.arr(out) if store else out

    def matmul(self, a, b, store: bool = True) -> np.ndarray:
        out = np.matmul(self.arr(a), self.arr(b)).astype(self.dtype)
        return self.arr(out) if store else out
