"""The lowering checks of the TPU build, as kernels held against their
twins.

Port of ``scripts/probe_mosaic_ops.py``: each construct that script asked
the TPU compiler to accept runs as its kernel of ``ops.kernels.lowering``
at the script's shapes and values, and must equal its plain twin on the
same device. One ``OK <construct>`` line per construct, named as the
script names it; any mismatch raises. Nothing is caught: a kernel that
does not build raises too.
"""

from __future__ import annotations

import torch

from ..ops.core import resolve_device
from ..ops.kernels import lowering as klow
from . import device_line


def inputs(device: torch.device, seed: int | None = None) -> dict:
    """The script's inputs (probe_mosaic_ops.py:29-30, :67-68, :95) or, given
    a ``seed``, seeded ones of the same shapes and types: int32 in
    [-3000, 3000), integer-valued bf16 in [-4, 4] (exact products and f32
    sums) and tokens in [-200, 1300) (negatives and tokens past the 8 hi
    rows count nowhere)."""
    if seed is None:
        return {
            "x": (torch.arange(32 * 128, dtype=torch.int32, device=device) % 500).view(32, 128),
            "f": torch.ones((256, 128), dtype=torch.bfloat16, device=device),
            "g": torch.ones((4096, 8), dtype=torch.bfloat16, device=device),
            "h": torch.ones((4096, 128), dtype=torch.bfloat16, device=device),
            "t1": (torch.arange(4096, dtype=torch.int32, device=device) % 500).view(4096, 1),
        }
    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    return {"x": ints((32, 128), -3000, 3000),
            "f": ints((256, 128), -4, 5).to(torch.bfloat16),
            "g": ints((4096, 8), -4, 5).to(torch.bfloat16),
            "h": ints((4096, 128), -4, 5).to(torch.bfloat16),
            "t1": ints((4096, 1), -200, 1300)}


def constructs(device: torch.device, seed: int | None = None) -> list:
    """(name, kernel, arguments) of each construct, in the script's order,
    on :func:`inputs`."""
    v = inputs(device, seed)
    return [
        ("reshape (32,128)->(4096,1)", klow.rows_to_column, (v["x"],)),
        ("reshape (32,128)->(4096,)->(4096,1) via [:,None]", klow.rows_to_column, (v["x"],)),
        ("transpose (32,128)->(128,32)", klow.transpose, (v["x"],)),
        ("iota mod trick (4096, 8)", klow.iota_mod_add, (v["x"], 4)),
        ("bf16 dot (128,256)@(256,128)", klow.dot_tn, (v["f"], v["f"])),
        ("skinny dot (4096,8)^T@(4096,128)", klow.dot_tn, (v["g"], v["h"])),
        ("onehot+dot from (4096,1) input", klow.onehot_dot, (v["t1"],)),
    ]


def twin(kernel):
    """The plain twin of a kernel of ``ops.kernels.lowering``."""
    return getattr(klow, f"{kernel.__name__}_reference")


def run(device="cuda") -> list[dict]:
    """Run every construct and hold it against its twin; print one OK line
    each and return the rows. Raises on the first mismatch."""
    dev = resolve_device(device)
    print(device_line(dev))
    out = []
    for name, kernel, args in constructs(dev):
        got, want = kernel(*args), twin(kernel)(*args)
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its twin: {tuple(got.shape)} "
                                 f"{got.dtype} against {tuple(want.shape)} {want.dtype}")
        row = {"construct": name, "shape": tuple(got.shape)}
        line = f"OK   {name}"
        if name.startswith("onehot"):
            row["sum"] = float(got.sum())
            line += f", sum={row['sum']}"
        print(line)
        out.append(row)
    return out
