"""Training state carried between the JAX package and the port.

The trainer's state is plain arrays: the token stream and its logical
length, the V*V upper-bound table ``ub``, the (M, 3) merge table, the
per-merge occupancy and the number of merges done ``k``. As numpy arrays it
moves between ``zigbpe_tpu`` (``np.asarray`` of its jax arrays) and the
port's tensors on any device, so both packages can resume from one state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.core import resolve_device


@dataclass
class TrainState:
    tokens: torch.Tensor     # int32[N] stream, PAD (-1) tailed rows
    length: int              # number of valid tokens
    ub: torch.Tensor         # int32[V*V] upper bounds on live pair counts
    merges: torch.Tensor     # int32[M, 3] (first, second, new), PAD rows
    occupancy: torch.Tensor  # int32[M] count of each merge when selected
    k: int                   # merges done

    @classmethod
    def from_numpy(cls, tokens, length, ub, merges, occupancy, k,
                   device="cpu") -> "TrainState":
        """Copy numpy (or array-like) state onto ``device``."""
        dev = resolve_device(device)

        def t(x):
            return torch.tensor(np.asarray(x, dtype=np.int32), device=dev)

        return cls(t(tokens), int(length), t(ub), t(merges), t(occupancy), int(k))

    def numpy(self) -> dict:
        """The state as numpy arrays and ints (keys as the fields)."""
        return {
            "tokens": self.tokens.cpu().numpy(),
            "length": self.length,
            "ub": self.ub.cpu().numpy(),
            "merges": self.merges.cpu().numpy(),
            "occupancy": self.occupancy.cpu().numpy(),
            "k": self.k,
        }
