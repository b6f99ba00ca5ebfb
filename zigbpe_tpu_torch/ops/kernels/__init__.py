"""Hand-written Hopper kernels of the BPE hot path and their plain twins.

Kernel choice follows the tensor's device and nothing else: a CPU tensor
runs the plain PyTorch twin, a CUDA tensor launches the CUDA kernel (built
from ``csrc/`` at first launch) or raises. There is no fallback from a CUDA
tensor to the twin.
"""

import torch

BLOCK = 32 * 128  # merge kernel tile: 32 rows of 128 tokens, one CUDA block
# Stream layout granularity: ROW-LOCAL prefixes (each 128-token row is a
# valid-token prefix with a PAD tail; see ops/kernels/merge.py).
# pair_streams(layout_block=LAYOUT) gives the logical adjacency.
LAYOUT = 128
PAD = -1


def compact_rows(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Stable per-row compaction of a [R, C] tensor, the twins' compaction:
    the kept values of each row, in order, then PAD (``cumsum``
    destinations and one ``scatter``)."""
    R, C = values.shape
    dest = torch.where(keep, torch.cumsum(keep, 1) - 1, C)
    out = torch.full((R, C + 1), PAD, dtype=values.dtype, device=values.device)
    out.scatter_(1, dest, torch.where(keep, values, PAD))
    return out[:, :C]
