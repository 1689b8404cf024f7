"""Token sampling for the serving engine: temperature / top-k / top-p (the
port of ``repro.serving.sampling``).

Greedy decoding (``temperature == 0``, the default) is a plain argmax over
the raw f32 logits, untouched by the rest. Non-greedy requests carry a
:class:`SamplingParams`; the sampler runs on the logits' device inside the
decode and prefill steps, so it adds no host round trip a tick.

Determinism contract (the reference's): token ``i`` of a request is a pure
function of ``(logits_i, seed, i)``, with ``key_i = fold_in(PRNGKey(seed),
i)`` and ``i`` counting the request's own generated tokens. Nothing about
scheduling enters the key, so streams reproduce across policies. The keys
and the draw are ``jax.random``'s, bit for bit
(:mod:`repro_torch.data.threefry`): the same seed gives the reference's
stream wherever the two filtered distributions agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.transport import host_to
from repro_torch.data import threefry

__all__ = ["SamplingParams", "GREEDY", "base_key", "sample_tokens",
           "slot_arrays", "set_slot"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls.

    temperature: 0.0 = greedy (the argmax; the default). > 0 divides the
        logits before the filters below.
    top_k: keep only the k highest logits (0 = off).
    top_p: nucleus sampling, the smallest prefix of the probability-sorted
        vocabulary whose mass reaches ``top_p`` (1.0 = off), after top_k.
    seed: base of the per-request key stream (see the module docstring).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def base_key(params: SamplingParams | None) -> np.ndarray:
    """The request's base key ``PRNGKey(seed)`` as two uint32 words (host
    side, once per request at admission; the per-token fold_in happens in
    the step)."""
    seed = 0 if params is None else params.seed
    return threefry.prng_key(seed).numpy().astype(np.uint32)


def _on(a, dev) -> torch.Tensor:
    """``a`` (numpy, a tensor or a scalar) as a tensor on ``dev``; uint32
    words become int64, which torch computes with."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32
                            else a)
    return a if a.device == dev else host_to(a.cpu(), dev)


def sample_tokens(logits: torch.Tensor, keys, steps, temperature, top_k,
                  top_p) -> torch.Tensor:
    """Sample one token per row; greedy rows take the plain argmax.

    logits: (B, V); keys: (B, 2) base keys (uint32 words); steps: (B,) the
    request-local token index; temperature (B,) f32; top_k (B,) (0 = off);
    top_p (B,) f32 (1 = off). The per-row arrays may lie on the host (numpy
    or tensors). Returns (B,) int64 token ids on the logits' device. The
    filters are the reference's: top-k keeps the logits at least the k-th
    largest, top-p the survivors whose probability is at least the smallest
    one kept by an exclusive cumulative mass under ``top_p``, and the draw
    is ``categorical(fold_in(key, step), masked)``."""
    dev = logits.device
    keys, steps, temperature, top_k, top_p = (
        _on(a, dev) for a in (keys, steps, temperature, top_k, top_p))
    keys = keys.to(torch.int64) & 0xFFFFFFFF
    logits = logits.to(torch.float32)
    V = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp_min(temperature.to(torch.float32),
                                      1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, torch.clamp(top_k.to(torch.int64) - 1, 0,
                                            V - 1)[:, None])
    keep = torch.where((top_k > 0)[:, None], scaled >= kth,
                       torch.ones_like(scaled, dtype=torch.bool))
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    probs = torch.softmax(torch.where(keep, scaled, neg_inf), dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    mass_before = torch.cumsum(sp, dim=-1) - sp
    kept_sorted = mass_before < top_p.to(torch.float32)[:, None]
    thr = torch.where(kept_sorted, sp, torch.inf).amin(dim=-1, keepdim=True)
    keep &= probs >= thr
    masked = torch.where(keep, scaled, neg_inf)
    folded = threefry.fold_in_rows(keys, steps)
    sampled = threefry.categorical(folded, masked)
    return torch.where(temperature > 0.0, sampled, greedy_tok)


def slot_arrays(n_slots: int) -> dict:
    """The host-side per-slot sampler state the engine updates at admission
    and release: keys (n, 2) uint32, temperature (n,), top_k (n,), top_p
    (n,). Free slots read as greedy."""
    return {
        "key": np.zeros((n_slots, 2), np.uint32),
        "temperature": np.zeros((n_slots,), np.float32),
        "top_k": np.zeros((n_slots,), np.int32),
        "top_p": np.ones((n_slots,), np.float32),
    }


def set_slot(arrays: dict, slot: int, params: SamplingParams | None) -> None:
    """Install one request's sampling parameters into its slot row."""
    p = params or GREEDY
    arrays["key"][slot] = base_key(p)
    arrays["temperature"][slot] = p.temperature
    arrays["top_k"][slot] = p.top_k
    arrays["top_p"][slot] = p.top_p
