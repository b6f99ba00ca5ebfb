"""zigbpe-tpu on PyTorch: the byte-level BPE tokenizer framework ported
from the JAX package ``zigbpe_tpu`` to PyTorch, with its merge kernel and
its batched encode kernel written by hand in CUDA for NVIDIA Hopper
(``csrc/merge.cu``, ``csrc/encode.cu``).

Capability parity with dbtreasure/zig-bpe on the train / encode / decode
path (merges.txt serde, profiling, CLI demo), plus batched serving
(``BasicTokenizer.encode_batch``). ``zigbpe_tpu`` stays the
reference the port is tested against; this package imports ``torch`` and
never ``jax`` or ``zigbpe_tpu``.
"""

from .models.basic_tokenizer import BasicTokenizer, InvalidTokenError
from .models import oracle
from .utils import serde
from .utils.profiling import TimeStats

__version__ = "0.1.0"

__all__ = [
    "BasicTokenizer",
    "InvalidTokenError",
    "oracle",
    "serde",
    "TimeStats",
    "__version__",
]
