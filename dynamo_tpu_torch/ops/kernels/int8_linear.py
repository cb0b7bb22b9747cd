"""Kernel K8, the weight-only int8 linear (W8A16), CUDA C++ in
``csrc/int8_linear.cu``.

K8 computes the function of ``dynamo_tpu/quant/int8.py`` ``qlinear`` and
``qlinear_expert``: ``y = ((h @ q) accumulated in f32) * s`` cast to
``h.dtype``, for h bf16 (or f32, the parity runs) ``[T, in]`` or ``[E, C,
in]``, q int8 ``[in, out]`` or ``[E, in, out]`` and s f32 ``[out]`` or
``[E, out]``. On the TPU it is no Pallas kernel: XLA fuses the int8 -> bf16
convert into the dot's operand read. An eager ``h @ q.to(h.dtype)`` would
write and read a bf16 copy of every weight on every call (1 + 2 + 2 bytes a
weight against the bf16 model's 2), which is why the port writes it by hand.

Bound on an H100: the int8 weight stream at decode sizes, the bf16 tensor
rate at prefill sizes. Two bodies (see the source note), chosen from h's
dtype and ``out`` alone by :func:`plan`:

- ``wgmma`` (bf16 h, out % 16 == 0: every served shape): each output tile
  computed transposed, the int8 weight converted to bf16 in registers as
  wgmma's A operand, h its B from shared memory, both loaded by TMA into a
  ring that one producer warp keeps full for two consumer warpgroups;
  tiles of BT token rows (T rounded up to 8 up to 64; 96 or 128 past it);
  when the tiles fill too few of the 132 SMs, K split over the 2-8 blocks
  of a thread-block cluster, their f32 partials summed in rank order through
  distributed shared memory: one launch, the same bits every launch.
- ``mma`` (f32 h, the parity runs; out % 16 != 0): 128-column
  tiles of 16-128 rows, a ``cp.async`` ring, ``mma.sync`` m16n8k16 (f32 h as
  bf16 hi + lo), K split over blocks with a second, fixed-order reduce
  launch.

Shapes it takes: in % 8 == 0, out % 4 == 0, h bf16 or f32; others raise.
Plain version: ``quant/int8.py qlinear_plain``; ``quant/int8.py qlinear`` /
``qlinear_expert`` pick it for CPU tensors and these launchers for CUDA
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dynamo_tpu_torch.ops.kernels import _build

A_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BK = 64  # both bodies' K stage: a split's rows are a multiple of it
BN = 128  # the mma body's output columns a block
# the mma body: blocks that keep the 132 SMs busy (about two each); below it
# K is split over blocks
TARGET_BLOCKS = 264
MIN_SPLIT_K = 256  # the least K rows a split takes (both bodies)
DEEP_ROWS = 64  # the wgmma body's tiles up to this many rows: 128 channels a block, else 256
CLUSTER_SPLITS = tuple(range(1, 9))  # the wgmma body's splits: the blocks of a cluster, at most 8
# the wgmma body's blocks resident at once in clusters of n, 1 block an SM
# (an H100 SXM's cudaOccupancyMaxActiveClusters: 132, 66, 39, 30, 22, 17, 15
# and 15 clusters; its GPCs leave SMs idle under clusters of 3 and more)
CLUSTER_BLOCKS = {1: 132, 2: 132, 3: 117, 4: 120, 5: 110, 6: 102, 7: 105, 8: 120}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 8 + [_P]
_WG_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P]


class Plan(NamedTuple):
    """How K8 runs one call: the body, its tile rows (wgmma: BT token rows;
    mma: 16 x row fragments), and K split into ``splits`` ranges of
    ``k_per_split`` rows (a multiple of BK; the last may be shorter)."""

    body: str
    rows: int
    splits: int
    k_per_split: int


def row_fragments(rows: int, n_tiles: int, experts: int, dtype=torch.bfloat16) -> int:
    """The mma body's rows a block in 16-row fragments (1, 2, 4 or 8): enough
    for ``rows`` up to 64; past that bf16 takes 128-row tiles where they
    still give TARGET_BLOCKS blocks, else (and f32 always) 64-row tiles."""
    if rows <= 64:
        return 1 if rows <= 16 else 2 if rows <= 32 else 4
    if dtype == torch.bfloat16 and n_tiles * -(-rows // 128) * experts >= TARGET_BLOCKS:
        return 8
    return 4


def k_splits(rows: int, K: int, blocks: int) -> tuple[int, int]:
    """The mma body's (splits, K rows a split, a multiple of BK) for
    ``blocks`` output tiles: enough splits to reach TARGET_BLOCKS, each at
    least MIN_SPLIT_K rows, and no more than keeps the f32 partials' traffic
    (written and read back: 8 bytes an output element a split) under the
    int8 weight's bytes, K / (8 rows) splits."""
    want = -(-TARGET_BLOCKS // blocks)
    n = max(1, min(want, K // MIN_SPLIT_K, K // (8 * rows)))
    per = -(-(-(-K // n)) // BK) * BK
    return -(-K // per), per


def tile_rows(T: int) -> int:
    """The wgmma body's BT: T rounded up to a multiple of 8 up to 64 (at most
    7 rows of padding at decode sizes), 96 or 128 past it."""
    if T <= DEEP_ROWS:
        return max(8, -(-T // 8) * 8)
    return 96 if T <= 96 else 128


def cluster_splits(tiles: int, K: int) -> tuple[int, int]:
    """The wgmma body's (splits, K rows a split) for ``tiles`` output tiles:
    the cluster size (1 to 8) that puts the most blocks to work while every
    block stays resident at once (CLUSTER_BLOCKS), each split at least
    MIN_SPLIT_K rows and every split non-empty, so the splits cover K
    exactly in multiples of BK."""
    stages = -(-K // BK)
    best = 1
    for n in CLUSTER_SPLITS:
        per = -(-stages // n)
        if tiles * n <= CLUSTER_BLOCKS[n] and per * BK >= MIN_SPLIT_K and (n - 1) * per < stages:
            best = n
    per = -(-stages // best) * BK
    return best, per


def plan(T: int, K: int, N: int, E: int = 1, dtype=torch.bfloat16) -> Plan:
    """The body and tiling for h [E, T, K] x q [E, K, N]: the wgmma body for
    bf16 h and N % 16 == 0, else the mma body."""
    if dtype == torch.bfloat16 and N % 16 == 0:
        bt = tile_rows(T)
        cols = 128 if bt <= DEEP_ROWS else 256
        splits, per = cluster_splits(-(-N // cols) * -(-T // bt) * E, K)
        return Plan("wgmma", bt, splits, per)
    mf = row_fragments(T, -(-N // BN), E, dtype)
    blocks = -(-N // BN) * -(-T // (16 * mf)) * E
    n_split, per = k_splits(T, K, blocks) if blocks < TARGET_BLOCKS else (1, -(-K // BK) * BK)
    return Plan("mma", 16 * mf, n_split, per)


def check_args(h, q, s, batched: bool) -> None:
    """Raise on inputs K8 does not take."""
    want = 3 if batched else 2
    if h.dim() != want or q.dim() != want or s.dim() != want - 1:
        form = "h [E, C, in], q [E, in, out], s [E, out]" if batched else "h [T, in], q [in, out], s [out]"
        raise ValueError(f"K8 takes {form}; got {tuple(h.shape)}, {tuple(q.shape)}, {tuple(s.shape)}")
    if h.dtype not in A_DTYPES or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"K8 takes bfloat16 or float32 h, int8 q and float32 s; got {h.dtype}, {q.dtype}, {s.dtype}")
    K, N = q.shape[-2:]
    if h.shape[-1] != K or s.shape[-1] != N or (batched and not h.shape[0] == q.shape[0] == s.shape[0]):
        raise ValueError(f"K8 shapes disagree: h {tuple(h.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}")
    if K % 8 or N % 4:
        raise ValueError(f"K8 takes in % 8 == 0 and out % 4 == 0; got in {K}, out {N}")
    for t in (q, s):
        if t.device != h.device:
            raise ValueError(f"all inputs must be on {h.device}; got {t.device}")


def _launch(h, q, s) -> torch.Tensor:
    """K8 on checked [E, T, K] x [E, K, N] inputs -> [E, T, N]."""
    E, T, K = h.shape
    N = q.shape[-1]
    out = torch.empty((E, T, N), dtype=h.dtype, device=h.device)
    if T == 0 or N == 0:
        return out
    h, q, s = _build.aligned16(h), _build.aligned16(q), _build.aligned16(s)
    p = plan(T, K, N, E, h.dtype)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if p.body == "wgmma":
        err = _build.entry("int8_linear", "w8a16_wgmma_linear", _WG_ARGTYPES)(
            h.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), E, T, K, N, p.rows, p.splits, p.k_per_split,
            stream,
        )
        _build.check(err, "w8a16_wgmma_linear", refused="in % 8 == 0 and out % 16 == 0")
        return out
    # the splits' f32 partials, alive past the launch like every workspace
    ws = torch.empty((p.splits, E, T, N), dtype=torch.float32, device=h.device) if p.splits > 1 else None
    err = _build.entry("int8_linear", "w8a16_linear", _ARGTYPES)(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        E, T, K, N, p.splits, p.k_per_split, p.rows // 16, A_DTYPES[h.dtype], stream,
    )
    _build.check(err, "w8a16_linear", refused="in % 8 == 0 and out % 4 == 0")
    return out


def int8_linear_kernel(h, q, s) -> torch.Tensor:
    """h [T, in] bf16 or f32, q [in, out] int8, s [out] f32 -> [T, out] in
    h's dtype. Launches K8 or raises: CUDA tensors only (``quant/int8.py
    qlinear`` sends CPU tensors to the plain version)."""
    if h.device.type != "cuda":
        raise ValueError(f"K8 runs on CUDA tensors; got {h.device}")
    check_args(h, q, s, batched=False)
    out = _launch(h[None], q[None], s[None])[0]
    int8_linear_kernel.launches += 1
    return out


def int8_linear_expert_kernel(h, q, s) -> torch.Tensor:
    """The expert banks' form: h [E, C, in], q [E, in, out] int8, s [E, out]
    f32 -> [E, C, out], one launch for every expert. CUDA tensors only
    (``quant/int8.py qlinear_expert`` sends CPU tensors to the plain
    version)."""
    if h.device.type != "cuda":
        raise ValueError(f"K8 runs on CUDA tensors; got {h.device}")
    check_args(h, q, s, batched=True)
    out = _launch(h, q, s)
    int8_linear_expert_kernel.launches += 1
    return out


int8_linear_kernel.launches = 0
int8_linear_expert_kernel.launches = 0
