"""The Mamba selective scan, token by token, the same bits for a token in
any call (the fixed-batch decode step and the serving engine's decode
ticks, prefill chunks and speculative verify calls).

For a CUDA tensor :func:`mamba_scan` launches the hand-written kernel in
``csrc/mamba_scan.cu`` on the current stream and counts the launch in its
``launches`` attribute; for a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.mamba_scan_recurrent_ref`. The kernel
replaces no TPU kernel: the reference runs this recurrence as a
``lax.scan`` over tokens (``repro/models/ssm.py:390-424``,
``mamba_scan_recurrent``, and its T = 1 step at ``:486-491``), which in
PyTorch is a Python loop of some six launches per token and layer. It has
no backward: a call on the card whose inputs need a gradient raises.

What bounds the kernel: at a decode tick or a verify call the state's
bytes (read once, written once or, collected, once a token) at 3.35
TB/s; at a prefill chunk the issue rate of its instructions, some 14 a
state and token, 8 of them ``expf``'s (the chunk's bytes, dt and dtx
read and y written, take less). What the design does about each: calls
of up to :data:`DIRECT_TOKENS` tokens take a direct path, each lane
reading its inputs from device memory (staging would only add latency)
and storing collected states evict-first; longer calls take a staged
path, blocks of 16 to 64 channels copying tiles of up to 64 tokens into
shared memory by ``cp.async``, two tiles ahead, so no token waits on
device memory, a lane computing 8 tokens' exps ahead of the dependent
chain, which is then one product and one sum a state and token, and y
leaving a tile at a time in 16-byte stores.

The kernel splits a channel's N states over N / 4 lanes and sums y's parts
in a butterfly over them: :data:`ORDER`, N's alone, is the order of that
sum. :func:`plan` is the launch (channels a block, threads, token tile,
stages, shared memory, grid), which may follow B, T and Di since it never
changes a sum; :func:`state_quads` is its map from threads to states, and
:func:`work` counts a call's bytes and operations for its bound.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

__all__ = ["D_STATES", "ORDER", "SCAN_TOL", "SCAN_STATE_TOL", "Plan",
           "plan", "state_quads", "scan_errors", "mamba_scan", "work"]

D_STATES = (8, 16)       # the kernel's N (Jamba reduced and full)
# y's sum over n (csrc/mamba_scan.cu): (states a lane, summed in order;
# lanes a channel, whose parts meet in a butterfly at offsets 1, 2, ...).
# N alone sets it, and with it every bit of a token's y.
ORDER = {8: (4, 2), 16: (4, 4)}
CHANNELS = (64, 32, 16)  # channels a block may own, widest first
MAX_TILE = 64            # tokens staged at a time, at most (two ballots)
MAX_STAGES = 3
MAX_SMEM = 232448        # a block's shared memory on sm_90 (227 KB)
# Channel groups are cut until the grid has about one block per SM of the
# H100's 132 (128 blocks at one row of Jamba's 8192 channels).
MIN_BLOCKS = 128
# Calls of at most this many tokens (decode ticks, verify calls) take the
# direct path: no staging, whose latency they could not hide; its blocks
# hold at most DIRECT_THREADS lanes.
DIRECT_TOKENS = 5
DIRECT_THREADS = 128
# The kernel against its plain version (:func:`scan_errors`). The state's
# update rounds each operation as the plain version's separate ops do, so
# the two differ only where the card's and the plain version's exp do (on
# the card they are one function); y's sum over n runs in another order
# and without fused multiply-adds: a few f32 units of the sum of its terms'
# magnitudes, which y's error scale holds.
SCAN_TOL = 1e-5
SCAN_STATE_TOL = 1e-5
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mamba_scan_forward": ([_I] + [_P] * 9 + [_I] * 9 + [_P], _I),
    "mamba_scan_error_string": ([_I], ctypes.c_char_p),
}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.load("mamba_scan", _SIGNATURES),
                                  name)
    return fn


class Plan(NamedTuple):
    """A launch of the kernel: ``quad`` states a lane and ``lanes`` lanes
    a channel (:data:`ORDER`, N's alone, the order of y's sum),
    ``channels`` a block (``Di // channels`` blocks a row), ``threads`` a
    block (``channels * lanes``, each a compute lane that also copies),
    ``tile`` tokens staged at a time in ``stages`` stages (0 stages: the
    direct path, a token at a time from device memory), ``smem`` bytes of
    dynamic shared memory and ``blocks`` in the grid."""
    quad: int
    lanes: int
    channels: int
    threads: int
    tile: int
    stages: int
    smem: int
    blocks: int


def _smem(N: int, channels: int, tile: int, T: int) -> int:
    """``csrc/mamba_scan.cu``'s ``layout``: 3 stages (fewer where T has
    fewer tiles) of a tile's dt and dtx (tile, channels) and Bm and C
    (tile, N), and 2 buffers (1 for one tile) of its y (tile, channels)."""
    tiles = -(-T // tile)
    stage = tile * (2 * channels + 2 * N) * 4
    return (min(tiles, MAX_STAGES) * stage
            + min(tiles, 2) * tile * channels * 4)


@functools.lru_cache(maxsize=256)
def plan(B: int, T: int, Di: int, N: int, tile: int | None = None,
         channels: int | None = None, staged: bool | None = None) -> Plan:
    """The launch of a call of B rows of T tokens, Di channels of N
    states. Calls of at most :data:`DIRECT_TOKENS` tokens take the direct
    path, in blocks of the widest group of :data:`CHANNELS` dividing Di
    within :data:`DIRECT_THREADS` lanes; longer ones the staged path, in
    blocks of the widest group dividing Di whose grid has
    :data:`MIN_BLOCKS` blocks (else 16), with the longest tile up to
    ``min(T, 64)`` tokens whose shared memory fits. ``tile``, ``channels``
    and ``staged``, when given, replace the choice (the GPU tests and
    ``tools/torch_mamba_ab.py --plans``)."""
    if N not in D_STATES or Di < 16 or Di % 16:
        raise ValueError(f"mamba_scan takes N in {D_STATES} and Di a "
                         f"multiple of 16, got N {N}, Di {Di}")
    quad, per = ORDER[N]
    if staged is None:
        staged = T > DIRECT_TOKENS
    if channels is None:
        channels = next((ch for ch in CHANNELS if Di % ch == 0 and (
            B * (Di // ch) >= MIN_BLOCKS if staged
            else ch * per <= DIRECT_THREADS)), CHANNELS[-1])
    elif channels not in CHANNELS or Di % channels or \
            (not staged and channels * per > DIRECT_THREADS):
        raise ValueError(f"mamba_scan's blocks own one of {CHANNELS} "
                         f"channels, dividing Di {Di} (at most "
                         f"{DIRECT_THREADS} lanes on the direct path); got "
                         f"{channels}")
    if not staged:
        if tile not in (None, 1):
            raise ValueError(f"mamba_scan's direct path takes a token at "
                             f"a time, not a tile of {tile}")
        return Plan(quad, per, channels, channels * per, 1, 0, 0,
                    B * (Di // channels))
    if tile is None:
        tile = max(1, min(T, MAX_TILE))
        while tile > 1 and _smem(N, channels, tile, T) > MAX_SMEM:
            tile -= 1
    elif not 1 <= tile <= MAX_TILE:
        raise ValueError(f"mamba_scan's tile is 1 to {MAX_TILE} tokens, "
                         f"got {tile}")
    return Plan(quad, per, channels, channels * per, tile,
                min(-(-T // tile), MAX_STAGES), _smem(N, channels, tile, T),
                B * (Di // channels))


def state_quads(p: Plan, B: int, Di: int) -> torch.Tensor:
    """The kernel's map from threads to states under plan ``p``: for each
    block and thread in launch order, (row, channel, first state) of the
    ``p.quad`` states it holds. Block ``blk`` takes row ``blk // (Di /
    channels)`` and channels from ``(blk % (Di / channels)) channels``;
    thread ``tid`` channel ``tid // lanes`` of them and quad ``tid %
    lanes``."""
    groups = Di // p.channels
    blk = torch.arange(p.blocks, dtype=torch.int64)[:, None]
    tid = torch.arange(p.threads, dtype=torch.int64)[None, :]
    row = (blk // groups).expand(-1, p.threads)
    chan = blk % groups * p.channels + tid // p.lanes
    first = tid % p.lanes * p.quad
    return torch.stack([row, chan, first.expand(p.blocks, -1)],
                       -1).reshape(-1, 3)


def work(B: int, T: int, Di: int, N: int, collect: bool = False) -> tuple:
    """(bytes, operations) of one call, for its bound: dt and dtx read and
    y written once (12 bytes a channel and token), Bm and C read once (8 N
    bytes a token), A, ``valid`` and the state read once, the state written
    once (with ``collect``, every token's state written); 6 f32 operations
    and one exp a state element and token, each counted as one: ``dt A``,
    its exp, the product with h, ``dtx Bm``, the sum, and ``h' C`` with its
    share of y's sum."""
    state = B * Di * N * 4
    nbytes = (12 * B * T * Di + 8 * N * B * T + 4 * Di * N + B * T + state
              + (T * state if collect else state))
    return nbytes, 7 * B * T * Di * N


def scan_errors(got: tuple, dt, dtx, Bm, C, A, state, valid=None,
                collect: bool = False) -> tuple:
    """How far ``got``, the kernel's ``(y, state)`` (``(y, states)`` with
    ``collect``) for these inputs, lies from the plain version's: (y's
    error, the state's). Each element's ``|got - want|`` over a scale: for
    y, ``|want|`` plus the largest ``|want|`` of its token's channels plus
    the sum of the magnitudes of the terms it sums, ``sum_n |h'[n] C[n]|``
    (what another order of the sum can move it by); for a state element,
    ``|want|`` plus the largest of its channel's N. The kernel passes
    within ``SCAN_TOL`` and ``SCAN_STATE_TOL``."""
    want_y, states = ref.mamba_scan_recurrent_ref(dt, dtx, Bm, C, A, state,
                                                  valid, collect=True)
    # h' of every token: the kept states, and at a pad the update it skipped
    prev = torch.cat([state[:, None], states[:, :-1]], 1)
    new = torch.exp(dt[..., None] * A) * prev + dtx[..., None] * Bm[:, :, None]
    del prev
    mag = (new * C[:, :, None]).abs_().sum(-1)
    del new
    want_state = states if collect else (states[:, -1] if states.shape[1]
                                         else state)

    def share(g, w, extra=None):
        if not g.numel():
            return 0.0
        g, w = g.double(), w.double()
        scale = w.abs() + w.abs().amax(-1, keepdim=True)
        if extra is not None:
            scale = scale + extra.double()
        return float(((g - w).abs() / scale.clamp_min(
            torch.finfo(torch.float64).tiny)).max())
    return share(got[0], want_y, mag), share(got[1], want_state)


def _check(dt, dtx, Bm, C, A, state, valid) -> None:
    if dt.dim() != 3 or dtx.shape != dt.shape:
        raise ValueError(f"mamba_scan takes dt and dtx of one shape (B, T, "
                         f"Di), got {tuple(dt.shape)} and {tuple(dtx.shape)}")
    B, T, Di = dt.shape
    if A.dim() != 2 or A.shape[0] != Di:
        raise ValueError(f"mamba_scan takes A ({Di}, N), got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    if Bm.shape != (B, T, N) or C.shape != (B, T, N) or \
            state.shape != (B, Di, N):
        raise ValueError(f"mamba_scan takes Bm and C ({B}, {T}, {N}) and "
                         f"state ({B}, {Di}, {N}), got {tuple(Bm.shape)}, "
                         f"{tuple(C.shape)} and {tuple(state.shape)}")
    if any(t.dtype != torch.float32 for t in (dt, dtx, Bm, C, A, state)):
        raise TypeError("mamba_scan takes dt, dtx, Bm, C, A and state in "
                        "f32")
    if valid is not None and (valid.shape != (B, T) or
                              valid.dtype != torch.bool):
        raise ValueError(f"valid must be ({B}, {T}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    tensors = [dtx, Bm, C, A, state] + ([] if valid is None else [valid])
    if any(t.device != dt.device for t in tensors) or \
            dt.device.type not in ("cpu", "cuda"):
        raise ValueError("mamba_scan's tensors must lie on one cpu or cuda "
                         "device")


def mamba_scan(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, state: torch.Tensor,
               valid: torch.Tensor | None = None,
               collect: bool = False) -> tuple:
    """The selective scan over the call's tokens (the reference's
    ``mamba_scan_recurrent``): dt, dtx (B, T, Di), Bm, C (B, T, N), A (Di,
    N), state (B, Di, N), all f32, ``valid`` (B, T) bool or None; an
    invalid token's state update is skipped (its y is still computed).
    Returns (y (B, T, Di) f32, the new state), or with ``collect`` (y,
    states (B, T, Di, N)), entry t the state after token t. On the card N
    must be one of :data:`D_STATES`, Di a multiple of 16, and the tensors
    contiguous, each starting on 16 bytes; the state is read, never
    written; :func:`plan` gives the launch."""
    _check(dt, dtx, Bm, C, A, state, valid)
    if dt.device.type == "cpu":
        return ref.mamba_scan_recurrent_ref(dt, dtx, Bm, C, A, state, valid,
                                            collect)
    tensors = (dt, dtx, Bm, C, A, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the mamba_scan kernel has no backward: Mamba "
                           "training on the card is ROADMAP.md queue 1, "
                           "'Next' item 3h")
    B, T, Di = dt.shape
    N = A.shape[1]
    p = plan(B, T, Di, N)               # raises for an N or Di it cannot
    if not all(t.is_contiguous() for t in tensors) or \
            (valid is not None and not valid.is_contiguous()):
        raise ValueError("mamba_scan's tensors must be contiguous")
    y = torch.empty_like(dt)
    new = torch.empty((B, T, Di, N) if collect else (B, Di, N),
                      dtype=torch.float32, device=dt.device)
    if not T or not B:
        if not collect:
            new.copy_(state)
        return y, new
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("mamba_scan's tensors must start on 16 bytes (the "
                         "kernel reads 16 bytes at a time)")
    f, dev = _fn("mamba_scan_forward"), dt.device
    args = (int(collect), dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), A.data_ptr(), state.data_ptr(),
            None if valid is None else valid.data_ptr(), y.data_ptr(),
            new.data_ptr(), B, T, Di, N, p.channels, p.tile, p.stages,
            p.threads, p.smem)
    if dev.index == torch.cuda.current_device():
        rc = f(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = f(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {rc} "
                           f"({_fn('mamba_scan_error_string')(rc).decode()})")
    mamba_scan.launches += 1
    return y, new


mamba_scan.launches = 0
