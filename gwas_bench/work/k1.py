"""K1's work, frozen: the operations and bytes of one fused Gram call.

A copy of ``pygemma_tpu_torch/ops/gram_kernel.py::flops_and_bytes`` as the
benchmark was defined, so that a change to the program cannot move the
yardstick.  It counts the algorithm's own work, whatever implements it.
"""

from __future__ import annotations

from typing import Tuple


def flops_and_bytes(n: int, B: int, R: int, m: int, s: int, kmax: int,
                    want_logh: bool) -> Tuple[float, float]:
    """Work of one fused Gram call over n samples, B SNP columns and R
    lambda slots, with m pair features of s shared columns: (floating-point
    operations, bytes).

    Per (sample, column): h (2), d (1), the powers (kmax-1), v*v (1), and
    per k one multiply d^k*v plus a multiply-add for each of the m+1 pair
    features, the s shared features and the v*v feature (kmax *
    (2*(m+s+2) + 1)); log h and its sum (2) when wanted.  Bytes: each input
    read once and each output written once, float32."""
    per = 2 + 1 + (kmax - 1) + 1 + kmax * (2 * (m + s + 2) + 1)
    if want_logh:
        per += 2
    flops = float(per) * n * B * R
    out_vals = B * R * (kmax * (m + s + 1) + 3)
    in_vals = B * R + n + n * m + n * s + n * B
    return flops, 4.0 * (in_vals + out_vals)
