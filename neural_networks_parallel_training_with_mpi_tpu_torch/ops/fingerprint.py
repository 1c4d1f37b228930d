"""Positional state digest: the fast path of the replica-consistency check.

``fingerprint(tensors)`` folds a list of tensors into per-leaf uint32
digests, their FNV-style chain and an advisory f32 magnitude: the JAX
package's ``utils/consistency.py`` ``Fingerprinter.device_fp`` (XLA ops
there; no Pallas kernel).  For leaf ``l`` of ``n_l`` elements::

    s_l    = sum_i bits(x_l[i]) * ((i * -1640531527) | 1)   mod 2**32
    fold_l = sum |x_l[::64]|                     (f32, float leaves only)
    h      = h * 16777619 + s_l   over the leaves, from -2128831035

``bits`` is the raw pattern as int32: f32 bitcast, bf16/f16 zero-extended
from uint16, int8 sign-extended, uint8/bool zero-extended, int32 as is,
int64 cut to its low 32 bits (JAX's ``_bits_i32``).  The odd position
factor makes any single changed element (any flipped bit, a NaN) change
the digest, and modular addition makes it independent of the summation
order: the kernel's digests equal the plain version's bitwise.

On CUDA tensors it launches the hand-written kernel ``csrc/fingerprint.cu``
(one launch for every leaf; built for ``sm_90a`` at first use, see
``ops._build``) or raises; on CPU tensors it computes the plain PyTorch
version, :func:`fingerprint_reference` (int32 products wrap, sums in
int64, the low 32 bits kept).  There is no fallback from the kernel to
the plain version.  Both return ``(digests, folds)``: an int64 tensor of
``n + 1`` values in ``[0, 2**32)`` (the per-leaf digests, then the chain)
and an f32 tensor of ``n + 1`` (the per-leaf folds, then their sum), on
the tensors' device, without a host sync.

Each kernel launch adds one to ``fingerprint.launches``.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

POS_MUL = -1640531527          # 0x9E3779B9 as int32
FNV_PRIME = 16777619
FNV_BASIS = 0x811C9DC5         # -2128831035 mod 2**32
MASK32 = 0xFFFFFFFF
CHUNK = 1 << 18                # elements per block: csrc/fingerprint.cu
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
         torch.float16: 3, torch.int8: 4, torch.uint8: 5, torch.bool: 5,
         torch.int64: 6}


def bits_i32(x: torch.Tensor) -> torch.Tensor:
    """The raw bit pattern of ``x`` as a flat int32 tensor."""
    x = x.detach().reshape(-1)
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    if x.dtype not in _CODE:
        raise ValueError(f"fingerprint: unsupported dtype {x.dtype}")
    return x.to(torch.int32)


def fingerprint_reference(tensors: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, on the tensors' own device."""
    if not tensors:
        return (torch.tensor([FNV_BASIS], dtype=torch.int64),
                torch.zeros(1, dtype=torch.float32))
    device = tensors[0].device
    sums, folds = [], []
    for x in tensors:
        u = bits_i32(x)
        pos = (torch.arange(u.numel(), dtype=torch.int32, device=device)
               * POS_MUL) | 1
        sums.append((u * pos).sum(dtype=torch.int64) & MASK32)
        if x.is_floating_point():
            folds.append(x.detach().reshape(-1)[::64].float().abs().sum())
        else:
            folds.append(torch.zeros((), dtype=torch.float32,
                                     device=device))
    h = torch.tensor(FNV_BASIS, dtype=torch.int64, device=device)
    for s in sums:
        h = (h * FNV_PRIME + s) & MASK32
    digests = torch.stack(sums + [h])
    f = torch.stack(folds)
    return digests, torch.cat([f, f.sum().reshape(1)])


class Table(NamedTuple):
    """The kernel's view of a leaf list: every leaf's pointer, size and
    type code (``key``), as a leaf table and a table of ``CHUNK``-element
    chunks on the leaves' card."""
    key: tuple
    leaves: torch.Tensor
    chunks: torch.Tensor
    n_chunks: int


def table_key(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((t.data_ptr(), t.numel(), _CODE[t.dtype]) for t in tensors)


def launch_table(tensors: Sequence[torch.Tensor]) -> Table:
    """The launch table of ``tensors`` (on a card).  It stays valid while
    each of them keeps its storage: build it once for a state updated in
    place and pass it to every :func:`fingerprint` of that state."""
    key = table_key(tensors)
    device = tensors[0].device
    leaves, chunks = [], []
    for i, (ptr, n, code) in enumerate(key):
        leaves += [ptr, n, code]
        for start in range(0, n, CHUNK):
            chunks += [i, start]
    return Table(key, torch.tensor(leaves, dtype=torch.int64).to(device),
                 torch.tensor(chunks or [0], dtype=torch.int64).to(device),
                 len(chunks) // 2)


def fingerprint(tensors: Sequence[torch.Tensor],
                table: Optional[Table] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-leaf digests + chain, per-leaf folds + sum (see the module
    docstring).  All tensors on one device, each contiguous.  ``table``:
    their :func:`launch_table`, built here when not given (CUDA only; a table
    built for other storage raises)."""
    tensors = list(tensors)
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"fingerprint: leaves on several devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop() if devices else torch.device("cpu")
    if device.type == "cpu":
        return fingerprint_reference(tensors)
    if device.type != "cuda":
        raise ValueError(f"fingerprint runs on cuda or cpu, not {device}")
    for t in tensors:
        if t.dtype not in _CODE:
            raise ValueError(f"fingerprint: unsupported dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fingerprint: every leaf must be contiguous")
    lib, _ = _build.load("fingerprint")
    fn = lib.fingerprint_launch
    if fn.argtypes is None:
        lib.fingerprint_chunk_elems.restype = ctypes.c_longlong
        lib.fingerprint_chunk_elems.argtypes = []
        if lib.fingerprint_chunk_elems() != CHUNK:
            raise RuntimeError("csrc/fingerprint.cu's chunk size differs "
                               "from ops/fingerprint.CHUNK")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
    if table is None:
        table = launch_table(tensors)
    elif table.key != table_key(tensors):
        raise ValueError("fingerprint: the table was built for other "
                         "tensors")
    n = len(tensors)
    digests = torch.empty(n + 1, dtype=torch.int32, device=device)
    folds = torch.empty(n + 1, dtype=torch.float32, device=device)
    err = fn(table.leaves.data_ptr(), table.chunks.data_ptr(), n,
             table.n_chunks,
             digests.data_ptr(), folds.data_ptr(),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fingerprint kernel launch failed: CUDA error "
                           f"{err}")
    fingerprint.launches += 1
    return digests.to(torch.int64) & MASK32, folds


fingerprint.launches = 0


def chain(leaf_digests: List[int]) -> int:
    """The FNV-style chain of per-leaf digests (host ints), as the kernel
    and the JAX Fingerprinter chain them."""
    h = FNV_BASIS
    for s in leaf_digests:
        h = (h * FNV_PRIME + int(s)) & MASK32
    return h
