"""The port's per-row LoRA kernel: the adapter update of the projections
that share one input.

``lora_apply_group(ys, x, group, slots)`` adds, into each target's output
``ys[t]`` in place, every row's low-rank update ``round(round(x .
a_t[s]^T) . b_t[s]^T)`` (``s`` the row's adapter slot; slot 0 rows are
neither read nor written), one call for the 1 to 3 targets of a group
(wq|wk|wv, wo, w_gate|w_up, w_down). It is the counterpart of the XLA
program of the reference's ``_maybe_lora``
(``generativeaiexamples_tpu/models/llama.py:271-303``), not of a Pallas
kernel. The kernel is CUDA C++ for ``sm_90a`` (``csrc/lora.cu``: what
bounds it and its design are written there), built by :mod:`.build` and
bound with ``ctypes``: one C call launches its two kernels.

The factors are checked once, when a tree becomes resident
(:class:`ResidentGroup`: dtype, contiguity, 16-byte alignment, the rank
and depth the kernel takes); a call checks only x, the ys and the slots.
Its plain version is ``ops/lora.py`` ``lora_apply_group_plain``, which
``ops.lora.lora_apply_group`` takes for CPU tensors; this wrapper takes
CUDA tensors only, launches the kernel or raises, and adds one to
``launch_counts()["lora"]`` a call. :func:`lora_apply` is one target's
call with factors checked on the spot. :func:`lora_supported` is the
support predicate the engine checks when an adapter is registered, and
:func:`lora_plan` the splits and tiles of a call, from shapes and the
card's SM count only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from generativeaiexamples_tpu_torch.ops.cuda.build import LAUNCHES

MAX_TARGETS = 3      # targets a call (wq|wk|wv)
MAX_RANK = 64
CHUNK = 128          # K a shrink stage (csrc CHUNK)
STAGES = 3           # the shrink's cp.async ring (csrc STAGES)
SHRINK_WARPS = 4     # warps a shrink CTA
SHRINK_SMEM = 216 * 1024   # the most shared memory a plan gives a shrink CTA
TILE_ROWS = 64       # rows an expand tile (wgmma's M)
TILE_COLS = 128      # columns an expand tile (wgmma's N)
MAX_SPLITS = 64      # shrink splits of K: partials the last CTA adds
MAX_STAGED = 4       # slots an expand CTA stages at once
# 16-byte vectors of the working type: the contraction depth and the rank
# are whole vectors
VECTOR = {torch.float32: 4, torch.bfloat16: 8}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_LIB = []
_SMS: Dict[int, int] = {}
# per device: (scratch bytes, tickets, their pointers, the two tensors),
# grown as calls need
_SCRATCH: Dict[int, tuple] = {}


class _Desc(ctypes.Structure):
    """A resident group as the C side reads it (csrc ``Group``)."""
    _fields_ = [("dtype", ctypes.c_int), ("nt", ctypes.c_int),
                ("K", ctypes.c_int), ("r", ctypes.c_int),
                ("O", ctypes.c_int * MAX_TARGETS),
                ("a", ctypes.c_void_p * MAX_TARGETS),
                ("b", ctypes.c_void_p * MAX_TARGETS)]


def _lib():
    if not _LIB:
        from generativeaiexamples_tpu_torch.ops.cuda import build
        lib = build.load("lora")
        lib.gk_lora_group.argtypes = _ARGS
        lib.gk_lora_group.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def supported_ranks(dtype: torch.dtype) -> Tuple[int, ...]:
    """The ranks the kernel takes for ``dtype``: whole 16-byte vectors up to
    ``MAX_RANK``."""
    v = VECTOR.get(dtype)
    return tuple(range(v, MAX_RANK + 1, v)) if v else ()


def lora_supported(rank: int, in_features: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes adapters of ``rank`` on a projection of
    ``in_features`` inputs in ``dtype`` (bf16 or f32): the rank and the
    contraction depth whole 16-byte vectors, the rank at most 64."""
    v = VECTOR.get(dtype)
    return bool(v) and rank in supported_ranks(dtype) and in_features % v == 0


def shrink_smem(G: int, SB: int, nt: int, r: int) -> int:
    """Shared memory of a bf16 shrink CTA (csrc ``shrink_smem``): the warps'
    [4][16][nt x RB] f32 sums and a ring of STAGES chunks of 16 G rows of x
    and SB slots x nt targets x RB rank rows of A, 2 CHUNK bytes a row."""
    rb = -(-r // 16) * 16
    return (4 * 16 * nt * rb * 4
            + STAGES * (16 * G + SB * nt * rb) * 2 * CHUNK)


@dataclass(frozen=True)
class LoraPlan:
    """A call's splits and tiles (csrc ``Args``): the shrink runs ``tiles``
    x ``P`` CTAs of ``G`` 16-row groups, K in ``P`` slices of whole
    chunks, up to ``SB`` slots' A rows a pass of its ring; the expand runs
    ``col_tiles`` x ``row_blocks`` CTAs of ``RT`` 64-row tiles, staging up
    to ``SB`` slots' B tiles at once."""

    P: int
    G: int
    RT: int
    SB: int
    tiles: int
    col_tiles: int
    row_blocks: int


def lora_plan(T: int, K: int, O: Sequence[int], n_sm: int, slots: int,
              r: int = 16) -> LoraPlan:
    """The plan from shapes only: T rows, depth K, the targets' widths O,
    the card's SM count, the stacked slots (1 for a global adapter) and
    the rank.

    Shrink: a decode batch (up to 8 groups of 16 rows) takes one group a
    CTA, its four warps sharing each chunk's 16-deep steps; a prefill
    batch four groups a CTA (two, or one, where the ring of a large rank
    over three targets would not fit). K is split into ``P`` interleaved
    slices of at least two chunks, enough that the grid holds two CTAs an
    SM, at most ``MAX_SPLITS`` partials. Expand: 128 columns a CTA and as
    many 64-row tiles as leave about four CTAs an SM (at most 8: B staged
    once serves them all). A decode batch stages every adapter slot at
    once (as many as the shrink's ring holds), a prefill batch (one slot
    a chunk) one."""
    groups = -(-T // 16)
    G = 1 if groups <= 8 else next(
        g for g in (4, 2, 1) if shrink_smem(g, 1, len(O), r) <= SHRINK_SMEM)
    tiles = -(-groups // G)
    chunks = -(-K // CHUNK)
    P = max(1, min(chunks // 2, MAX_SPLITS, -(-2 * n_sm // tiles)))
    row_tiles = -(-T // TILE_ROWS)
    col_tiles = sum(-(-o // TILE_COLS) for o in O)
    RT = max(1, min(8, row_tiles * col_tiles // (4 * n_sm)))
    SB = 1 if T > 4 * TILE_ROWS else min(MAX_STAGED, max(1, slots - 1))
    while SB > 1 and shrink_smem(G, SB, len(O), r) > SHRINK_SMEM:
        SB -= 1
    return LoraPlan(P=P, G=G, RT=RT, SB=SB, tiles=tiles,
                    col_tiles=col_tiles, row_blocks=-(-row_tiles // RT))


def split_chunks(K: int, plan: LoraPlan) -> List[List[int]]:
    """The chunks of K each shrink split walks, in order, the kernel's
    arithmetic: split s takes s, s + P, s + 2P, ..., so that neighbouring
    CTAs read neighbouring chunks of the same rows."""
    C = -(-K // CHUNK)
    return [list(range(s, C, plan.P)) for s in range(plan.P)]


def scratch_bytes(dtype: torch.dtype, nt: int, r: int, T: int, P: int
                  ) -> int:
    """The scratch a call needs (csrc ``scratch_bytes``): z (T, nt x r
    rounded up to 16) of the working type, and with P > 1 the f32
    partials after it."""
    zw = nt * (-(-r // 16) * 16)
    zb = -(-(T * zw * (4 if dtype == torch.float32 else 2)) // 256) * 256
    return zb + (P * T * zw * 4 if P > 1 else 0)


def _n_sm(idx: int) -> int:
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _scratch(dev: torch.device, idx: int, nbytes: int, tiles: int
             ) -> Tuple[int, int]:
    """Pointers to the device's scratch and tickets, grown to ``nbytes``
    and ``tiles``; tickets start at 0 and every call leaves them so."""
    got = _SCRATCH.get(idx)
    if got is not None and got[0] >= nbytes and got[1] >= tiles:
        return got[2], got[3]
    ws_bytes, n_tiles = (got[0], got[1]) if got else (0, 0)
    ws = got[4] if got and ws_bytes >= nbytes else torch.empty(
        (max(nbytes, 1 << 20),), dtype=torch.uint8, device=dev)
    cnt = got[5] if got and n_tiles >= tiles else torch.zeros(
        (max(tiles, 1024),), dtype=torch.int32, device=dev)
    _SCRATCH[idx] = (ws.numel(), cnt.numel(), ws.data_ptr(), cnt.data_ptr(),
                     ws, cnt)
    return ws.data_ptr(), cnt.data_ptr()


def _stream(idx: int) -> int:
    """The device's current CUDA stream as a raw pointer (PyTorch's own
    launchers read it so, without making a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(idx)


class ResidentGroup:
    """One layer's factors of the targets of a group, checked once for the
    kernel: ``a`` and ``b`` tuples (one entry a target) of stacked (N, r,
    K) / (N, O_t, r) slots or a global adapter's (r, K) / (O_t, r), bf16
    or f32 alike, contiguous and 16-byte aligned on one CUDA device, one
    rank and depth the kernel takes. Raises ValueError on anything else.
    Holds the tensors (the C side reads their pointers) and each input
    shape's plan."""

    __slots__ = ("a", "b", "dtype", "stacked", "N", "r", "K", "O", "device",
                 "index", "_desc", "addr", "_calls")

    def __init__(self, a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]):
        a, b = tuple(a), tuple(b)
        if not 1 <= len(a) <= MAX_TARGETS or len(b) != len(a):
            raise ValueError(f"lora_apply: a group takes 1 to {MAX_TARGETS} "
                             f"targets' a and b, got {len(a)} and {len(b)}")
        stacked = a[0].dim() == 3
        sa = [t if stacked else t[None] for t in a]
        sb = [t if stacked else t[None] for t in b]
        if any(t.dim() != 3 for t in sa + sb):
            raise ValueError("lora_apply: factors are all stacked (N, r, K) "
                             "/ (N, O, r) or all a global (r, K) / (O, r)")
        N, r, K = sa[0].shape
        dtype = a[0].dtype
        if dtype not in _DTYPES or any(t.dtype != dtype for t in a + b):
            raise ValueError(f"lora_apply takes bf16 or f32 x, y, a and b "
                             f"alike, got {[t.dtype for t in a + b]}")
        for t, u in zip(sa, sb):
            if tuple(t.shape) != (N, r, K) or u.shape[0] != N \
                    or u.shape[2] != r:
                raise ValueError(f"lora_apply: a {tuple(t.shape)}, b "
                                 f"{tuple(u.shape)} do not agree with "
                                 f"({N}, {r}, {K})")
        if not lora_supported(r, K, dtype):
            raise ValueError(f"lora_apply: rank {r} with {K} inputs outside "
                             f"the kernel's limits for {dtype} (ranks "
                             f"{supported_ranks(dtype)}, inputs whole "
                             f"16-byte vectors)")
        dev = a[0].device
        if dev.type != "cuda" or any(t.device != dev for t in a + b):
            raise ValueError(f"lora_apply takes CUDA tensors on one device, "
                             f"got {[str(t.device) for t in a + b]}")
        if (not all(t.is_contiguous() for t in a + b)
                or any(t.data_ptr() % 16 for t in a + b)):
            raise ValueError("lora_apply: tensors must be contiguous, x, a "
                             "and b 16-byte aligned")
        self.a, self.b = a, b
        self.dtype, self.stacked = dtype, stacked
        self.N, self.r, self.K = N, r, K
        self.O = tuple(int(u.shape[1]) for u in sb)
        self.device = dev
        self.index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        n = len(a)
        pad = lambda vals, ctype: (ctype * MAX_TARGETS)(
            *(list(vals) + [0] * (MAX_TARGETS - n)))
        self._desc = _Desc(_DTYPES[dtype], n, K, r,
                           pad(self.O, ctypes.c_int),
                           pad([t.data_ptr() for t in a], ctypes.c_void_p),
                           pad([t.data_ptr() for t in b], ctypes.c_void_p))
        self.addr = ctypes.addressof(self._desc)
        self._calls: Dict[Tuple[int, int], tuple] = {}

    def call_plan(self, B: int, S: int) -> tuple:
        """What a call over x (B, S, K) needs, cached: x's, each y's and the
        slots' shapes, then T, P, G, RT, SB, the scratch bytes and the
        shrink's row tiles (tickets)."""
        got = self._calls.get((B, S))
        if got is None:
            T = B * S
            pl = lora_plan(T, self.K, self.O, _n_sm(self.index),
                           self.N if self.stacked else 1, self.r)
            got = (torch.Size((B, S, self.K)),
                   tuple(torch.Size((B, S, o)) for o in self.O),
                   torch.Size((B,)), T, pl.P, pl.G, pl.RT, pl.SB,
                   scratch_bytes(self.dtype, len(self.a), self.r, T, pl.P),
                   pl.tiles)
            self._calls[(B, S)] = got
        return got


def _bad(what: str, t: Optional[torch.Tensor], want) -> ValueError:
    got = None if t is None else (tuple(t.shape), t.dtype, str(t.device),
                                  t.is_contiguous())
    return ValueError(f"lora_apply: {what} must be {want}, contiguous, on "
                      f"the group's device; got (shape, dtype, device, "
                      f"contiguous) {got}")


def lora_apply_group(ys: Sequence[torch.Tensor], x: torch.Tensor,
                     group: ResidentGroup, slots: Optional[torch.Tensor]
                     ) -> Sequence[torch.Tensor]:
    """One call: ``ys[t] += round(round(x . a_t[s]^T) . b_t[s]^T)`` in place
    for every row whose slot is not 0, each target t of ``group``; returns
    ys. x (B, S, K), 16-byte aligned, and each y (B, S, O_t), contiguous in
    the group's dtype on its device; slots (B,) int32 for stacked factors
    (row (i, j) takes slots[i]), None for a global adapter. Raises on
    anything else, and on a failed launch. The checks are the fewest that
    keep the launch within its tensors (the factors were checked when they
    became resident)."""
    dt, idx = group.dtype, group.index
    xs = x.shape
    if len(xs) != 3 or len(ys) != len(group.O):
        raise _bad("x", x, f"(B, S, {group.K}) with {len(group.O)} outputs")
    if xs[0] * xs[1] == 0:
        return ys
    (xshape, yshapes, sshape, T, P, G, RT, SB, nbytes,
     tiles) = group.call_plan(xs[0], xs[1])
    if (x.dtype is not dt or xs != xshape or not x.is_contiguous()
            or x.get_device() != idx):
        raise _bad("x", x, (tuple(xshape), dt))
    xp = x.data_ptr()
    if xp & 15:
        raise ValueError("lora_apply: x must be 16-byte aligned")
    ptrs = [None] * MAX_TARGETS
    for t, y in enumerate(ys):
        if (y.dtype is not dt or y.shape != yshapes[t]
                or not y.is_contiguous() or y.get_device() != idx):
            raise _bad(f"y {t}", y, (tuple(yshapes[t]), dt))
        ptrs[t] = y.data_ptr()
    if group.stacked:
        if (slots is None or slots.dtype is not torch.int32
                or slots.shape != sshape or not slots.is_contiguous()
                or slots.get_device() != idx):
            raise _bad("slots", slots, (tuple(sshape), torch.int32))
        sp = slots.data_ptr()
    elif slots is not None:
        raise ValueError("lora_apply: stacked factors take slots, a global "
                         "adapter none")
    else:
        sp = None
    ws, cnt = _scratch(group.device, idx, nbytes, tiles)
    rc = _lib().gk_lora_group(group.addr, xp, sp, ptrs[0], ptrs[1], ptrs[2],
                              T, xs[1], ws, cnt, P, G, RT, SB, _stream(idx))
    if rc != 0:
        raise RuntimeError(f"lora_apply kernel launch failed: CUDA error {rc}")
    LAUNCHES["lora"] += 1
    return ys


def lora_apply(y: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, slots: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """One target's call, its factors checked on the spot: ``y +=
    round(round(x . a[s]^T) . b[s]^T)`` in place for every row whose slot
    is not 0, and returns y. x (B, S, K) and y (B, S, O); stacked factors
    a (N, r, K), b (N, O, r) with slots (B,) int32; or a global adapter a
    (r, K), b (O, r) with slots None. Raises on anything else, and on a
    failed launch."""
    if not y.is_cuda:
        raise ValueError(f"lora_apply takes CUDA tensors, got {y.device}")
    if (a.dim() == 3) != (slots is not None):
        raise ValueError("lora_apply: stacked factors take slots, a global "
                         "adapter none")
    return lora_apply_group((y,), x, ResidentGroup((a,), (b,)), slots)[0]
