"""The optimizer update: the gradients' global norm, then one fused pass of
optax's ``clip_by_global_norm`` → ``adamw`` | ``sgd`` and the EMA.

    ‖g‖ = √(Σ_tensors Σ x²)                        in a fixed order (below)
    g'  = ‖g‖ < clip ? g : (g / ‖g‖) · clip        (no epsilon, as optax)
    AdamW: μ ← g'·(1−β1) + μ·β1;  ν ← (g'·g')·(1−β2) + ν·β2
           p ← p + ((μ / bc1) / (√(ν / bc2) + ε) + p·wd) · (−lr)
           (on the card μ / bc1 is μ · (1/bc1), as torch's CUDA foreach
           division by a scalar computes it; on the CPU a quotient)
    SGD:   μ ← μ·0.9 + g';  p ← p + μ · (−lr)
    EMA:   e ← e·d + p·(1−d), on the updated p

On CUDA tensors :func:`global_norm` and :func:`optim_apply` run the
hand-written kernels of ``csrc/optim.cu`` (the library
``native.libraries.OPTIM``, built with ``-fmad=false``):
``global_sumsq_partial`` and ``global_sumsq_finish`` for the norm, which
stays on the card, and ``optim_apply``, which reads it there, for the rest.
The lists go to each launch by value, so no launch copies or waits. On CPU
tensors they run the plain versions :func:`global_norm_reference` and
:func:`optim_apply_reference`, which on the card give the kernels' results
bit for bit (on the CPU the bias corrections divide, one rounding where the
card's foreach multiplies by a reciprocal). There is no fallback: a CUDA
tensor gets the kernels or an exception. Their launches count as the
roles ``global_norm`` and ``optim_apply``.

The norm's order is a function of the shapes alone (:func:`chunk_plan`):
the gradients are cut, tensor by tensor in their order, into chunks of at
most :data:`CHUNK` entries; within a chunk, thread t of :data:`THREADS`
adds the squares of entries 4·(i·THREADS + t) + u in the order (i, u); the
threads' sums are halved in a fixed tree; the chunks' sums are added the
same way (thread t takes partials t, t + THREADS, …, then the tree), and
the square root taken. Each square and each sum is rounded on its own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..native import libraries as NL

THREADS = 256
CHUNK = 16384
GROUPS = CHUNK // (4 * THREADS)
MAX_TENSORS = 192            # tensors a launch takes (its parameter struct)
B1, B2, EPS = 0.9, 0.999, 1e-8
MOMENTUM = 0.9
KINDS = {"adamw": 0, "sgd": 1, "ema": 2}


@dataclasses.dataclass(frozen=True)
class Step:
    """One optimizer call: ``kind`` "adamw", "sgd" or "ema" (the EMA pass
    alone, on a ``MultiSteps`` mini-step that applied nothing); ``lr`` from
    the schedule; ``count`` the update's count (after it), for Adam's bias
    correction; ``ema_decay`` d as a float32, or None without EMA."""
    kind: str
    lr: float = 0.0
    count: int = 0
    clip: float = 0.0
    weight_decay: float = 0.0
    ema_decay: Optional[np.float32] = None


def bias_corrections(count: int) -> tuple:
    """(1 − β1^t, 1 − β2^t) in float32, t the count after the update."""
    t = np.float32(count)
    return np.float32(1) - np.float32(B1) ** t, np.float32(1) - np.float32(B2) ** t


def kernel_scalars(step: Step) -> list:
    """The float32 values the plain chain multiplies and adds by on the
    card: [clip, 1−β1, β1 (the momentum for SGD), 1−β2, β2, 1/bc1, 1/bc2,
    ε, wd, −lr, d, 1−d]; the Python floats as torch casts them to float32.
    (torch's CUDA ``_foreach_div`` by a scalar multiplies by the float32
    reciprocal of the scalar.)"""
    bc1, bc2 = bias_corrections(step.count)
    one = np.float32(1)
    d = one if step.ema_decay is None else np.float32(step.ema_decay)
    return [np.float32(x) for x in (
        step.clip, 1 - B1, MOMENTUM if step.kind == "sgd" else B1, 1 - B2, B2, one / bc1,
        one / bc2, EPS, step.weight_decay, -step.lr, d, one - d)]


def chunk_plan(numels: Sequence[int], chunk: int = CHUNK,
               max_tensors: int = MAX_TENSORS) -> tuple:
    """(chunks, launches) of a list of tensors of ``numels`` entries:
    ``chunks[c]`` = (tensor, start, length), the consecutive runs of at most
    ``chunk`` entries of each tensor, tensors in their order; ``launches[l]``
    = (first tensor, end tensor, first chunk, end chunk), runs of at most
    ``max_tensors`` whole tensors in order, those with no chunk left out."""
    chunks, first = [], []
    for i, n in enumerate(numels):
        first.append(len(chunks))
        chunks += [(i, s, min(chunk, n - s)) for s in range(0, n, chunk)]
    first.append(len(chunks))
    launches = [(a, min(a + max_tensors, len(numels)), first[a],
                 first[min(a + max_tensors, len(numels))])
                for a in range(0, len(numels), max_tensors)]
    return chunks, [x for x in launches if x[3] > x[2]]


@functools.lru_cache(maxsize=32)
def _plan(numels: tuple) -> tuple:
    """(chunks, launches) of :func:`chunk_plan`, counted once per list of sizes."""
    chunks, launches = chunk_plan(numels)
    return len(chunks), tuple(launches)


def _halve(acc: torch.Tensor) -> torch.Tensor:
    """The kernels' tree over the last axis (a power of two): t + w onto t."""
    w = acc.shape[-1]
    while w > 1:
        w //= 2
        acc = acc[..., :w] + acc[..., w:2 * w]
    return acc[..., 0]


def global_norm_reference(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version of the kernels' norm, elementwise float32 ops only:
    each tensor zero-padded to whole chunks and read as [chunks, GROUPS,
    THREADS, 4]; squared; added over (group, u) one slice at a time; halved
    over the threads; the partials added the same way; the square root."""
    dev = tensors[0].device if len(tensors) else torch.device("cpu")
    parts = []
    for t in tensors:
        x = t.detach().reshape(-1).to(torch.float32)
        c = -(-x.numel() // CHUNK)
        if c:
            parts.append(F.pad(x, (0, c * CHUNK - x.numel())).view(c, GROUPS, THREADS, 4))
    if not parts:
        return torch.zeros((), dtype=torch.float32, device=dev)
    x = torch.cat(parts)
    sq = x * x
    acc = torch.zeros((x.shape[0], THREADS), dtype=torch.float32, device=dev)
    for i in range(GROUPS):
        for u in range(4):
            acc = acc + sq[:, i, :, u]
    partials = _halve(acc)
    rows = -(-partials.numel() // THREADS)
    p = F.pad(partials, (0, rows * THREADS - partials.numel())).view(rows, THREADS)
    acc = torch.zeros(THREADS, dtype=torch.float32, device=dev)
    for r in range(rows):
        acc = acc + p[r]
    return torch.sqrt(_halve(acc))


def optim_apply_reference(norm: Optional[torch.Tensor], grads, params, mu, nu, ema,
                          step: Step) -> None:
    """The plain chain with ``torch._foreach_*`` calls, in place: clip by
    ``norm``, AdamW or SGD into ``mu`` (and ``nu``), the update of
    ``params``, then the EMA of ``ema`` with ``step.ema_decay`` (none when
    ``ema`` is None); kind "ema" runs the EMA alone."""
    if step.kind != "ema":
        keep = norm < step.clip
        updates = [torch.where(keep, g, g / norm * step.clip) for g in grads]
        if step.kind == "sgd":
            torch._foreach_mul_(mu, MOMENTUM)
            torch._foreach_add_(mu, updates)          # trace: g + 0.9 t
            updates = mu
        else:
            updates = _adam(updates, params, mu, nu, step)
        torch._foreach_add_(params, torch._foreach_mul(updates, -step.lr))
    if ema is not None:
        d = step.ema_decay
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul(params, float(np.float32(1) - d)))


def _adam(g, params, mu, nu, step: Step) -> List[torch.Tensor]:
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2))
    bc1, bc2 = bias_corrections(step.count)
    mu_hat = torch._foreach_div(mu, float(bc1))
    nu_hat = torch._foreach_div(nu, float(bc2))
    torch._foreach_sqrt_(nu_hat)
    torch._foreach_add_(nu_hat, EPS)
    updates = torch._foreach_div(mu_hat, nu_hat)
    torch._foreach_add_(updates, torch._foreach_mul(params, step.weight_decay))
    return updates


def grad_layout(t: torch.Tensor) -> Optional[tuple]:
    """How the kernels read gradient ``t`` in place: (0, 0) if it is
    contiguous; (C, S) if it is stored channels-last (dims [O, C, spatial]
    laid out [O, spatial, C], as cuDNN returns a conv's weight gradient),
    S the product of the spatial dims; None for any other layout."""
    if t.is_contiguous():
        return 0, 0
    if t.dim() in (4, 5) and t.is_contiguous(
            memory_format=torch.channels_last if t.dim() == 4 else torch.channels_last_3d):
        return t.shape[1], math.prod(t.shape[2:])
    return None


def _check(name: str, lists: dict, numels: List[int], dev: torch.device) -> None:
    """Every tensor float32 on ``dev`` (a CUDA device) with the entries of
    ``numels`` (each under 2^31); gradients contiguous or channels-last,
    the rest contiguous."""
    if dev.type != "cuda" or max(numels, default=0) >= 2 ** 31:
        raise ValueError(f"{name} kernel: tensors of under 2^31 entries on a CUDA device, "
                         f"not on {dev}")
    for what, ts in lists.items():
        if len(ts) != len(numels):
            raise ValueError(f"{name} kernel: {len(ts)} {what} for {len(numels)} tensors")
        for i, (t, n) in enumerate(zip(ts, numels)):
            if (t.get_device() != dev.index or t.dtype != torch.float32 or t.numel() != n
                    or not (t.is_contiguous() or what == "grads" and grad_layout(t))):
                raise ValueError(f"{name} kernel: {what}[{i}] must be a float32 tensor of {n} "
                                 f"entries on {dev} in a layout the kernel reads, got "
                                 f"{t.dtype} of {t.numel()} on {t.device}")


def _ptrs(ts, a: int, b: int):
    return (ctypes.c_void_p * (b - a))(*[t.data_ptr() for t in ts[a:b]]) if ts else None


def _layouts(ts, a: int, b: int):
    return (ctypes.c_int * (2 * (b - a)))(*[x for t in ts[a:b] for x in grad_layout(t)])


@functools.lru_cache(maxsize=None)
def _lib():
    """The library, once its layout is checked against this module's."""
    lib = NL.load(NL.OPTIM)
    got = (ctypes.c_int * 3)()
    lib.optim_layout(got)
    if tuple(got) != (THREADS, CHUNK, MAX_TENSORS):
        raise RuntimeError(f"{NL.OPTIM.source.name} has layout {tuple(got)}, ops/optim.py "
                           f"{(THREADS, CHUNK, MAX_TENSORS)}")
    return lib


def global_norm_kernel(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``global_sumsq_partial`` (one launch per :func:`chunk_plan` launch)
    then ``global_sumsq_finish``: ‖tensors‖ as a 0-d float32 tensor on their
    device; no host sync."""
    if not len(tensors):
        raise ValueError("global_norm kernel: an empty list")
    dev = tensors[0].device
    numels = tuple(t.numel() for t in tensors)
    _check("global_norm", {"grads": tensors}, numels, dev)
    n_chunks, launches = _plan(numels)
    partials = torch.empty(n_chunks, dtype=torch.float32, device=dev)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    lib = _lib()
    for a, b, c0, _ in launches:
        NL.launch("global_norm", lib.global_sumsq_partial, dev, _ptrs(tensors, a, b),
                  (ctypes.c_int * (b - a))(*numels[a:b]), _layouts(tensors, a, b), b - a,
                  partials.data_ptr() + 4 * c0)
    NL.launch("global_norm", lib.global_sumsq_finish, dev, partials.data_ptr(), n_chunks,
              norm.data_ptr())
    return norm


def optim_apply_kernel(norm, grads, params, mu, nu, ema, step: Step) -> None:
    """``optim_apply`` (one launch per :func:`chunk_plan` launch): as
    :func:`optim_apply_reference`, in place, on the card; ``norm`` stays
    there."""
    kind = KINDS[step.kind]
    lists = {"params": params}
    if step.kind != "ema":
        lists.update(grads=grads, mu=mu)
    if step.kind == "adamw":
        lists["nu"] = nu
    if ema is not None:
        lists["ema"] = ema
    elif step.kind == "ema":
        raise ValueError("optim_apply kernel: kind 'ema' without EMA tensors")
    dev = params[0].device
    numels = tuple(t.numel() for t in params)
    _check("optim_apply", lists, numels, dev)
    if step.kind != "ema" and (norm.device != dev or norm.dtype != torch.float32
                               or norm.numel() != 1):
        raise ValueError(f"optim_apply kernel: norm must be one float32 on {dev}")
    scal = (ctypes.c_float * 12)(*kernel_scalars(step))
    lib = _lib()
    for a, b, _, _ in _plan(numels)[1]:
        NL.launch("optim_apply", lib.optim_apply, dev,
                  *(_ptrs(lists.get(k), a, b) for k in ("grads", "params", "mu", "nu", "ema")),
                  (ctypes.c_int * (b - a))(*numels[a:b]),
                  _layouts(lists.get("grads", params), a, b), b - a, scal, kind,
                  int(ema is not None), norm.data_ptr() if step.kind != "ema" else None)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax ``global_norm`` in the fixed order: the kernels on CUDA tensors,
    the plain version on CPU ones."""
    if not len(tensors) or tensors[0].device.type == "cpu":
        return global_norm_reference(tensors)
    return global_norm_kernel(tensors)


def optim_apply(norm, grads, params, mu, nu, ema, step: Step) -> None:
    """One optimizer call in place (see :func:`optim_apply_reference`): the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if params[0].device.type == "cpu":
        return optim_apply_reference(norm, grads, params, mu, nu, ema, step)
    optim_apply_kernel(norm, grads, params, mu, nu, ema, step)
