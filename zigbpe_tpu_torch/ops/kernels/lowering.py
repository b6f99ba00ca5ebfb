"""The lowering checks of the TPU build: the CUDA kernels' wrappers and
their plain PyTorch twins.

Counterparts of the Pallas kernels of ``scripts/probe_mosaic_ops.py``
(``try_kernel`` at :21, ``skinny`` at :77, ``onehot_dot`` at :97); the
kernels are ``csrc/lowering.cu``:
- :func:`rows_to_column`: (rows, cols) int32 -> (rows * cols, 1), read flat
  (both Pallas spellings of the reshape);
- :func:`transpose`: (rows, cols) int32 -> (cols, rows);
- :func:`iota_mod_add`: ``x + column index % m``, int32;
- :func:`dot_tn`: ``a^T . b`` of bf16 (K, M) and (K, N) in f32, on the
  tensor cores (the (256,128) product and the skinny (4096,8) one); M or N
  a multiple of 16, the other of 8, K of 16;
- :func:`onehot_dot`: ``hi^T . lo`` of an int32 token column (n, 1), hi =
  ``(t >> 7) == iota(8)``, lo = ``(t & 127) == iota(128)``: the (8, 128)
  f32 count of the tokens in each bin of [0, 1024); n a multiple of 16.

The TPU script catches a construct that does not lower and prints FAIL;
these catch nothing: a kernel that does not build raises, and one that is
wrong fails its twin check.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAYOUT, _build

HI_ROWS = 8  # the hi one-hot of onehot_dot: t >> 7 in [0, 8)


def _check_int(x: torch.Tensor, dims: int = 2) -> None:
    if x.dtype != torch.int32 or x.dim() != dims or x.numel() == 0:
        raise ValueError(f"x must be a non-empty {dims}-d int32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _dot_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Checks the shapes of ``dot_tn``; True when the kernel computes the
    transpose ``b^T . a`` (M below 16 rows)."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be 2-d bf16, got {a.dtype} {tuple(a.shape)} and "
                         f"{b.dtype} {tuple(b.shape)}")
    (K, M), (Kb, N) = a.shape, b.shape
    if K != Kb or K == 0 or K % 16:
        raise ValueError(f"a and b must share K, a positive multiple of 16: {K}, {Kb}")
    if M % 16 == 0 and M and N % 8 == 0 and N:
        return False
    if N % 16 == 0 and N and M % 8 == 0 and M:
        return True
    raise ValueError(f"dot_tn needs M or N a multiple of 16 and the other of 8, got M={M} "
                     f"N={N}")


def _check_tokens(t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 1 or t.shape[0] % 16 \
            or t.shape[0] == 0:
        raise ValueError(f"t must be an int32 (n, 1) column, n a positive multiple of 16, "
                         f"got {t.dtype} {tuple(t.shape)}")


def rows_to_column_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`rows_to_column`."""
    _check_int(x)
    return x.reshape(-1, 1).clone()


def transpose_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`transpose`."""
    _check_int(x)
    return x.t().contiguous()


def iota_mod_add_reference(x: torch.Tensor, m: int) -> torch.Tensor:
    """Plain twin of :func:`iota_mod_add`."""
    _check_int(x)
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device) % m + x


def dot_tn_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`dot_tn`: products of the bf16 values (exact in
    f32) summed over K in f32 by ``sum``."""
    _dot_layout(a, b)
    return (a.float()[:, :, None] * b.float()[:, None, :]).sum(0)


def onehot_dot_reference(t: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`onehot_dot`: a ``bincount`` of the tokens in
    [0, 8 * 128)."""
    _check_tokens(t)
    v = t.view(-1)
    v = v[(v >= 0) & (v < HI_ROWS * LAYOUT)]
    return torch.bincount(v.long(), minlength=HI_ROWS * LAYOUT).float().view(HI_ROWS, LAYOUT)


def _cuda(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors (or its twin on CPU ones); got a "
                         f"tensor on {x.device}")


def _run(entry: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = getattr(_library(), entry)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def rows_to_column(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, cols) int32 read flat into one column (rows * cols, 1)."""
    if x.device.type == "cpu":
        return rows_to_column_reference(x)
    _cuda(x, "rows_to_column")
    _check_int(x)
    x = x.contiguous()
    out = torch.empty((x.numel(), 1), dtype=torch.int32, device=x.device)
    _run("zbpe_rows_to_column", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    rows_to_column.launches += 1
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, cols) int32 transposed to (cols, rows)."""
    if x.device.type == "cpu":
        return transpose_reference(x)
    _cuda(x, "transpose")
    _check_int(x)
    x = x.contiguous()
    out = torch.empty((x.shape[1], x.shape[0]), dtype=torch.int32, device=x.device)
    _run("zbpe_transpose", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1])
    transpose.launches += 1
    return out


def iota_mod_add(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x[r, c] + c % m`` (int32)."""
    if x.device.type == "cpu":
        return iota_mod_add_reference(x, m)
    _cuda(x, "iota_mod_add")
    _check_int(x)
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    x = x.contiguous()
    out = torch.empty_like(x)
    _run("zbpe_iota_mod_add", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
         m)
    iota_mod_add.launches += 1
    return out


def dot_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T . b`` of bf16 (K, M) and (K, N), f32 (M, N), on the tensor
    cores; with M below 16 rows the kernel computes ``b^T . a`` and stores
    it transposed."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return dot_tn_reference(a, b)
    _cuda(a, "dot_tn")
    _cuda(b, "dot_tn")
    swap = _dot_layout(a, b)
    a, b = a.contiguous(), b.contiguous()
    (K, M), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if swap:  # D'[n][m] = sum_k b[k][n] a[k][m], stored at out[m][n]
        args = (b.data_ptr(), a.data_ptr(), out.data_ptr(), K, N, M, 1, N)
    else:
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), K, M, N, N, 1)
    _run("zbpe_dot_tn", a.device, *args)
    dot_tn.launches += 1
    return out


def onehot_dot(t: torch.Tensor) -> torch.Tensor:
    """``hi^T . lo`` of the token column ``t`` (n, 1): (8, 128) f32."""
    if t.device.type == "cpu":
        return onehot_dot_reference(t)
    _cuda(t, "onehot_dot")
    _check_tokens(t)
    t = t.contiguous()
    out = torch.empty((HI_ROWS, LAYOUT), dtype=torch.float32, device=t.device)
    _run("zbpe_onehot_dot", t.device, t.data_ptr(), out.data_ptr(), t.shape[0])
    onehot_dot.launches += 1
    return out


KERNELS = (rows_to_column, transpose, iota_mod_add, dot_tn, onehot_dot)
for _fn in KERNELS:
    _fn.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library("lowering")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
        ("zbpe_rows_to_column", [P, P, I, P]),
        ("zbpe_transpose", [P, P, I, I, P]),
        ("zbpe_iota_mod_add", [P, P, I, I, I, P]),
        ("zbpe_dot_tn", [P, P, P, I, I, I, I, I, P]),
        ("zbpe_onehot_dot", [P, P, I, P]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib
