"""Where a kernel wrapper's host time goes: each piece of a launch through
ctypes, timed alone.

    python -m zigbpe_tpu_torch.probes launch [--calls 10000]

Each piece runs ``calls`` times back to back after a tenth as many warm-up
calls, on the host clock (``time.perf_counter``) with the card synchronised
before and after, in three rounds; a row gives the median microseconds per
call and the range. The pieces are what a call of ``rows_to_column`` or
``transpose`` does on the host at the lowering script's shape (32, 128),
with the ways to allocate its output; the launch entry called bare (with
n = 0 it returns before any CUDA call: the ctypes cost alone), and the same
entry from a library built with ``-cudart shared``; the launch helper
(``_build.Entry``) and the launch path it replaced (a device context, a
Stream object and ``getattr`` on the library); the wrappers whole; the
two PyTorch calls that compute the same functions; and a whole call of
every other wrapper, each through ``_build.Entry``, at a small shape: the
merge pass on 4096 tokens, the encode kernel on one row of 1024, and the
copy, op mix and histogram kernels on (32, 128). Runs on a CUDA device
only: there is no launch to time on the host.
"""

from __future__ import annotations

import ctypes
import statistics
import time

import torch

from ..ops.core import resolve_device
from ..ops.kernels import _build
from ..ops.kernels import copy as kcopy
from ..ops.kernels import encode as kencode
from ..ops.kernels import hist as khist
from ..ops.kernels import lowering as klow
from ..ops.kernels import merge as kmerge
from ..ops.kernels import opmix as kopmix
from . import device_line

SHAPE = (32, 128)  # probe_mosaic_ops.py's x
CUDART_SHARED = ("-cudart", "shared")


def _entry(flags):
    """``zbpe_rows_to_column`` of the library built with ``flags``."""
    entry = klow._ROWS_TO_COLUMN
    fn = getattr(_build.library(entry.name, flags), entry.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [*entry.argtypes, ctypes.c_void_p]
    return fn


def pieces(dev: torch.device) -> list:
    """(name, function of no arguments) of each piece, in a call's order."""
    x = (torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.int32, device=dev) % 500).view(SHAPE)
    out = torch.empty((x.numel(), 1), dtype=torch.int32, device=dev)
    xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()
    index = x.get_device()
    lib = _build.library("lowering")
    static = _entry(_build.NVCC_FLAGS)
    shared = _entry(_build.NVCC_FLAGS + CUDART_SHARED)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_context():
        with torch.cuda.device(dev):
            pass

    def checks():
        if x.device.type == "cpu":
            raise AssertionError
        klow._cuda(x, "rows_to_column")
        klow._check_int(x)

    def old_path():  # the launch path before _build.Entry: device context, Stream, getattr
        with torch.cuda.device(dev):
            rc = getattr(lib, "zbpe_rows_to_column")(xp, op, n,
                                                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(rc)

    return [
        ("torch.cuda.device(dev) enter + exit", device_context),
        ("torch.cuda.current_stream()", torch.cuda.current_stream),
        ("torch.cuda.current_stream().cuda_stream", lambda: torch.cuda.current_stream().cuda_stream),
        ("torch._C._cuda_getCurrentRawStream(i)", lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("torch.cuda.current_device()", torch.cuda.current_device),
        ("torch._C._cuda_getDevice()", torch._C._cuda_getDevice),
        ("x.get_device()", x.get_device),
        ("x.device", lambda: x.device),
        ("x.data_ptr()", x.data_ptr),
        ("argument checks", checks),
        ("x.contiguous()", x.contiguous),
        ("torch.empty((4096, 1), int32, device=x.device)",
         lambda: torch.empty((4096, 1), dtype=torch.int32, device=x.device)),
        ("torch.empty((4096, 1), int32, device=index)",
         lambda: torch.empty((4096, 1), dtype=torch.int32, device=index)),
        ("x.new_empty((4096, 1))", lambda: x.new_empty((4096, 1))),
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("torch.empty_like(x).view(4096, 1)", lambda: torch.empty_like(x).view(4096, 1)),
        ("getattr(cached library, entry)", lambda: getattr(lib, "zbpe_rows_to_column")),
        ("bare ctypes call, n = 0 (no CUDA call)", lambda: static(xp, op, 0, stream)),
        ("bare ctypes launch (static cudart)", lambda: static(xp, op, n, stream)),
        ("bare ctypes launch (-cudart shared)", lambda: shared(xp, op, n, stream)),
        ("launch helper _build.Entry", lambda: klow._ROWS_TO_COLUMN(index, xp, op, n)),
        ("old launch path (device context, Stream, getattr)", old_path),
        ("rows_to_column(x), whole wrapper", lambda: klow.rows_to_column(x)),
        ("transpose(x), whole wrapper", lambda: klow.transpose(x)),
        ("x.view(-1, 1).clone()", lambda: x.view(-1, 1).clone()),
        ("x.t().contiguous()", lambda: x.t().contiguous()),
        *wrappers(dev),
    ]


def wrappers(dev: torch.device) -> list:
    """(name, function of no arguments) of a whole call of each wrapper
    outside ``lowering``, at a small shape."""
    x = (torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.int32, device=dev) % 500).view(SHAPE)
    tokens = x.view(-1).clone()  # rewritten in place by each pass: (97, 98) never hits
    table = torch.tensor([[97, 98, 256]], dtype=torch.int32, device=dev)
    row = x.view(-1)[:1024].view(1, 1024)
    gt, gl = (t.to(dev) for t in map(torch.from_numpy, kencode.schedule_merges([[97, 98, 256]])))
    return [
        ("merge_pass_multi(4096 tokens), whole wrapper",
         lambda: kmerge.merge_pass_multi(tokens, table)),
        ("encode_rows_grouped((1, 1024)), whole wrapper",
         lambda: kencode.encode_rows_grouped(row, gt, gl)),
        ("copy_blocks(x, 32), whole wrapper", lambda: kcopy.copy_blocks(x, 32)),
        ("copy_peek(x, 32), whole wrapper", lambda: kcopy.copy_peek(x, 32)),
        ("opmix(x, 32, 4), whole wrapper", lambda: kopmix.opmix(x, 32, 4)),
        ("onehot_hist(x, 32, 512, 8, 7, skip), whole wrapper",
         lambda: khist.onehot_hist(x, 32, 512, 8, 7, True)),
    ]


def time_piece(fn, calls: int, rounds: int = 3) -> list[float]:
    """Microseconds per call of ``fn()`` in each of ``rounds`` spans of
    ``calls`` calls, after ``calls // 10`` warm-up calls."""
    for _ in range(max(1, calls // 10)):
        fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return out


def run(device="cuda", calls: int = 10_000) -> list[dict]:
    """Time every piece; print and return one row each."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the launch probe times CUDA launches; got device {dev}")
    print(device_line(dev))
    print(f"launch: host microseconds per call, {calls} calls back to back, median "
          f"[min-max] of 3 rounds; x is {SHAPE} int32")
    out = []
    for name, fn in pieces(dev):
        us = time_piece(fn, calls)
        row = {"piece": name, "us": statistics.median(us), "us_min": min(us), "us_max": max(us)}
        print(f"{name:52s} {row['us']:8.3f} us [{row['us_min']:.3f}-{row['us_max']:.3f}]")
        out.append(row)
    return out
