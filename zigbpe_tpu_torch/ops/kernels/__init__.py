"""Hand-written Hopper kernels of the BPE hot path and their plain twins.

Kernel choice follows the tensor's device and nothing else: a CPU tensor
runs the plain PyTorch twin, a CUDA tensor launches the CUDA kernel (built
from ``csrc/`` at first launch) or raises. There is no fallback from a CUDA
tensor to the twin.
"""

BLOCK = 32 * 128  # merge kernel tile: 32 rows of 128 tokens, one CUDA block
# Stream layout granularity: ROW-LOCAL prefixes (each 128-token row is a
# valid-token prefix with a PAD tail; see ops/kernels/merge.py).
# pair_streams(layout_block=LAYOUT) gives the logical adjacency.
LAYOUT = 128
