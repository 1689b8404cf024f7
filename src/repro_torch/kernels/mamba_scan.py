"""The Mamba selective scan, token by token, the same bits for a token in
any call (the fixed-batch decode step and the serving engine's decode
ticks, prefill chunks and speculative verify calls).

For a CUDA tensor :func:`mamba_scan` launches the hand-written kernel in
``csrc/mamba_scan.cu`` on the current stream and counts the launch in its
``launches`` attribute; for a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.mamba_scan_recurrent_ref`. The kernel
replaces no TPU kernel: the reference runs this recurrence as a
``lax.scan`` over tokens (``repro/models/ssm.py``,
``mamba_scan_recurrent``), which in PyTorch is a Python loop of some six
launches per token and layer. It has no backward: a call on the card whose
inputs need a gradient raises. The kernel splits a channel's N states
over N / 4 lanes and sums y's parts in a butterfly over them: N alone
sets the order of that sum. :func:`work` counts a call's bytes and
operations for its bound.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["D_STATES", "SCAN_TOL", "SCAN_STATE_TOL", "scan_errors",
           "mamba_scan", "work"]

D_STATES = (8, 16)       # the kernel's N (Jamba reduced and full)
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
    "mamba_scan_forward": ([_I] + [_P] * 9 + [_I] * 4 + [_P], _I),
    "mamba_scan_error_string": ([_I], ctypes.c_char_p),
}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.load("mamba_scan", _SIGNATURES),
                                  name)
    return fn


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
    written."""
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
    if N not in D_STATES or Di % 16:
        raise ValueError(f"mamba_scan takes N in {D_STATES} and Di a "
                         f"multiple of 16, got N {N}, Di {Di}")
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
            new.data_ptr(), B, T, Di, N)
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
