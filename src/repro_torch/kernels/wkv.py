"""The RWKV-6 WKV recurrence, token by token, the same bits for a token in
any call (the fixed-batch decode step and the serving engine's decode
ticks, prefill chunks and speculative verify calls).

For a CUDA tensor :func:`wkv6` launches the hand-written kernel in
``csrc/wkv6.cu`` on the current stream and counts the launch in its
``launches`` attribute; for a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.wkv6_recurrent_ref`. The kernel replaces no
TPU kernel: the reference runs this recurrence as a ``lax.scan`` over
tokens (``repro/models/ssm.py``, ``wkv_recurrent``), which in PyTorch is a
Python loop of some seven launches per token and layer. It has no
backward: a call on the card whose inputs need a gradient raises.
:func:`plan` is the kernel's launch (its column groups, threads, token
tile and shared memory; the order of every sum is its ``rows``, K's alone),
:func:`state_tiles` its threads' share of the state, and :func:`work` a
call's bytes and operations for its bound.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

__all__ = ["HEAD_DIMS", "ROWS", "WKV_TOL", "WKV_STATE_TOL", "Plan", "plan",
           "state_tiles", "wkv_errors", "wkv6", "work"]

HEAD_DIMS = (16, 64)     # the kernel's K (RWKV-6 7B reduced and full)
# The state rows a thread owns and sums in order (csrc/wkv6.cu, rows_for):
# with the quads of the bonus and its butterfly, what fixes the order of
# every sum. K alone sets it.
ROWS = {16: 2, 64: 4}
MAX_TILE = 32            # tokens staged at a time, at most
MAX_SMEM = 232448        # a block's shared memory on sm_90 (227 KB)
# Column groups are cut until the grid has about one block per SM of the
# H100's 132 (128 blocks at one row of 64 heads).
MIN_BLOCKS = 128
# The kernel against its plain version (:func:`wkv_errors`). Both compute in
# f32 and differ in the order of each output's sum over k and in fused
# multiply-adds: a few f32 units of the sum of its terms' magnitudes, which
# the error's scale holds (over a long state those terms can be a thousand
# times the output). A bf16 output may then land on the other side of a
# rounding midpoint: one bf16 unit, 2**-8 of |want| + its row's largest at
# most, hence 2**-7. The state stays in f32 in both.
WKV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
WKV_STATE_TOL = 1e-5
_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "wkv6_forward": ([_I, _I] + [_P] * 9 + [_I] * 8 + [_P], _I),
    "wkv6_error_string": ([_I], ctypes.c_char_p),
}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.load("wkv6", _SIGNATURES), name)
    return fn


class Plan(NamedTuple):
    """A launch of the kernel: ``rows`` by ``cols`` state elements an owner
    thread holds (``rows``, K's alone, fixes every sum's order), ``group``
    state columns a block owns (``K // group`` blocks a row and head),
    ``owners`` and ``threads`` a block (the rest are helpers: copies, the
    prepare and o's sum), ``tile`` tokens staged at a time, ``smem`` bytes
    of dynamic shared memory and ``blocks`` in the grid."""
    rows: int
    cols: int
    group: int
    owners: int
    threads: int
    tile: int
    smem: int
    blocks: int


def _smem(K: int, group: int, tile: int, itemsize: int, T: int) -> int:
    """``csrc/wkv6.cu``'s ``layout``: 3 stages (fewer where T has fewer
    tiles) of a tile's raw r, k, the group's v and w_log, and 2 buffers (1
    for one tile) of w, a and valid and of the o partials (tile, K / rows,
    group)."""
    tiles = -(-T // tile)
    raw = tile * ((2 * K + group) * itemsize + 4 * K)
    work = (tile * 4 * K + 5 * tile + 15) // 16 * 16
    part = tile * (K // ROWS[K]) * group * 4
    return min(tiles, 3) * raw + min(tiles, 2) * (work + part)


@functools.lru_cache(maxsize=256)
def plan(B: int, T: int, H: int, K: int, itemsize: int = 2,
         group: int | None = None, tile: int | None = None) -> Plan:
    """The launch of a call of B rows of T tokens, H heads of K, r/k/v of
    ``itemsize`` bytes: the widest column group (K, or 32 for f32 r/k/v;
    then halves down to 16) whose grid has :data:`MIN_BLOCKS` blocks;
    owners of 16 columns where the group is 64, else of 4 (one row of 64
    heads then still runs 4 owner warps an SM); helpers as many as the
    owners where they own 4 columns, else one warp; the longest tile up
    to ``min(T, 32)`` tokens whose shared memory fits (``group`` and
    ``tile``, when given, replace the choice: ``tools/torch_wkv_ab.py
    --plans``)."""
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes K in {HEAD_DIMS}, got {K}")
    rows = ROWS[K]
    if group is None:
        # f32 inputs stop at 32 columns: 16 columns of f32 v an owner
        # would not fit its registers
        group = 32 if K == 64 and itemsize == 4 else K
        while group > 16 and B * H * (K // group) < MIN_BLOCKS:
            group //= 2
    cols = 16 if group == 64 else 4
    owners = K // rows * (group // cols)
    threads = owners + (owners if cols == 4 else 32)
    if tile is None:
        tile = max(1, min(T, MAX_TILE))
        while tile > 1 and _smem(K, group, tile, itemsize, T) > MAX_SMEM:
            tile -= 1
    return Plan(rows, cols, group, owners, threads, tile,
                _smem(K, group, tile, itemsize, T), B * H * (K // group))


def state_tiles(p: Plan, K: int) -> list:
    """The kernel's map from a block's owner threads to one head's state:
    for each column group ``cg`` (block ``(b * H + h) * (K // p.group) +
    cg``), owner and quad of its columns, the (first row, first column) of
    the ``p.rows`` x 4 elements. Owner ``tid`` takes row group ``tid //
    n`` and the column quads ``tid % n + n j``, ``n = group / cols``."""
    n = p.group // p.cols
    return [(tid // n * p.rows, cg * p.group + (tid % n + n * j) * 4)
            for cg in range(K // p.group) for tid in range(p.owners)
            for j in range(p.cols // 4)]


def work(B: int, T: int, H: int, K: int, itemsize: int = 2,
         collect: bool = False) -> tuple:
    """(bytes, operations) of one call, for its bound: r, k, v read and o
    written once in the input type, w_log once in f32, u once, ``valid``,
    the state read once and written once (with ``collect``, every token's
    state written); the f32 operations the recurrence needs, 5 K^2 + 5 K
    per token and head: ``r . S`` 2 K^2, the update ``w * S + k v^T`` 3
    K^2, and the bonus ``(sum_k r_k u_k k_k) v`` 5 K, as the kernel does
    it."""
    tokens = B * T * H * K
    state = B * H * K * K * 4
    nbytes = (4 * tokens * itemsize + 4 * tokens + 4 * H * K + B * T
              + state + (T * state if collect else state))
    return nbytes, B * T * H * (5 * K * K + 5 * K)


def wkv_errors(got: tuple, r, k, v, w_log, u, state, valid=None,
               collect: bool = False) -> tuple:
    """How far ``got``, the kernel's ``(o, state)`` (``(o, states)`` with
    ``collect``) for these inputs, lies from the plain version's: (o's
    error, the state's). Each element's ``|got - want|`` over a scale: for
    o, ``|want|`` plus the largest ``|want|`` of its head's K outputs plus
    the sum of the magnitudes of the terms it sums, ``sum_k |r_k (S_kv +
    u_k k_k v_v)|`` with S the state before the token (what another order
    of the sum can move it by); for a state element, ``|want|`` plus the
    largest of its row. The kernel passes within ``WKV_TOL`` of o's dtype
    and ``WKV_STATE_TOL``."""
    f32 = torch.float32
    want_o, states = ref.wkv6_recurrent_ref(r, k, v, w_log, u, state, valid,
                                            collect=True)
    prev = torch.cat([state.to(f32)[:, None], states[:, :-1]], 1)
    kv = k.to(f32)[..., :, None] * v.to(f32)[..., None, :]
    terms = (prev + u.to(f32)[:, :, None] * kv).abs_()
    del prev, kv
    mag = (r.to(f32).abs()[..., None] * terms).sum(-2)
    del terms
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
    return share(got[0], want_o, mag), share(got[1], want_state)


def _check(r, k, v, w_log, u, state, valid) -> None:
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape or \
            w_log.shape != r.shape:
        raise ValueError(f"wkv6 takes r, k, v and w_log of one shape (B, T, "
                         f"H, K), got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} and {tuple(w_log.shape)}")
    B, T, H, K = r.shape
    if u.shape != (H, K) or state.shape != (B, H, K, K):
        raise ValueError(f"wkv6 takes u ({H}, {K}) and state ({B}, {H}, {K}, "
                         f"{K}), got {tuple(u.shape)} and "
                         f"{tuple(state.shape)}")
    if r.dtype not in _FLOAT_CODE or k.dtype != r.dtype or \
            v.dtype != r.dtype:
        raise TypeError(f"wkv6 takes r, k and v in f32 or bf16 of one "
                        f"dtype, got {r.dtype}, {k.dtype} and {v.dtype}")
    if any(t.dtype != torch.float32 for t in (w_log, u, state)):
        raise TypeError(f"wkv6 takes w_log, u and state in f32, got "
                        f"{w_log.dtype}, {u.dtype} and {state.dtype}")
    if valid is not None and (valid.shape != (B, T) or
                              valid.dtype != torch.bool):
        raise ValueError(f"valid must be ({B}, {T}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    tensors = [k, v, w_log, u, state] + ([] if valid is None else [valid])
    if any(t.device != r.device for t in tensors) or \
            r.device.type not in ("cpu", "cuda"):
        raise ValueError("wkv6's tensors must lie on one cpu or cuda device")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
         valid: torch.Tensor | None = None, collect: bool = False) -> tuple:
    """The recurrence over the call's tokens (the reference's
    ``wkv_recurrent``): r, k, v (B, T, H, K) in f32 or bf16, w_log (B, T,
    H, K) f32, u (H, K) f32, state (B, H, K, K) f32, ``valid`` (B, T) bool
    or None; an invalid token's state update is skipped (its output is
    still computed). Returns (o (B, T, H, K) in r's dtype, the new state),
    or with ``collect`` (o, states (B, T, H, K, K)), entry t the state after
    token t. On the card K must be one of :data:`HEAD_DIMS` and the tensors
    contiguous, each starting on 16 bytes; the state is read, never
    written; :func:`plan` gives the launch."""
    _check(r, k, v, w_log, u, state, valid)
    if r.device.type == "cpu":
        return ref.wkv6_recurrent_ref(r, k, v, w_log, u, state, valid,
                                      collect)
    tensors = (r, k, v, w_log, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the wkv6 kernel has no backward: RWKV training "
                           "on the card is ROADMAP.md queue 1, 'Next' item 3")
    B, T, H, K = r.shape
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes K in {HEAD_DIMS}, got {K}")
    if not all(t.is_contiguous() for t in tensors) or \
            (valid is not None and not valid.is_contiguous()):
        raise ValueError("wkv6's tensors must be contiguous")
    out = torch.empty_like(r)
    new = torch.empty((B, T, H, K, K) if collect else (B, H, K, K),
                      dtype=torch.float32, device=r.device)
    if not T or not B * H:
        if not collect:
            new.copy_(state)
        return out, new
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("wkv6's tensors must start on 16 bytes (the kernel "
                         "reads 16 bytes at a time)")
    p = plan(B, T, H, K, r.element_size())
    f, dev = _fn("wkv6_forward"), r.device
    args = (_FLOAT_CODE[r.dtype], int(collect), r.data_ptr(), k.data_ptr(),
            v.data_ptr(), w_log.data_ptr(), u.data_ptr(), state.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(),
            new.data_ptr(), B, T, H, K, p.group, p.tile, p.threads, p.smem)
    # the raw stream handle, as block_combine's launches take it
    if dev.index == torch.cuda.current_device():
        rc = f(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = f(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {rc} "
                           f"({_fn('wkv6_error_string')(rc).decode()})")
    wkv6.launches += 1
    return out, new


wkv6.launches = 0
