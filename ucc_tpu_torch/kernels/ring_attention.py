"""Ring flash-attention forward: the CUDA kernel of
``csrc/ring_flash_attn.cu``, its wrapper, and its plain PyTorch version.

``ring_flash_attention_fwd`` replaces ``ucc_tpu/fused_attention.py:_kernel``
(the Pallas kernel ``_build`` compiles): every rank ``me`` of an n-rank
sequence-parallel ring holds q (h, s, d) and k, v (h_kv, s, d), its block
of s consecutive positions, and gets back exact attention of its queries
against the whole sequence,

    o_me = softmax(scale · q_me · [k_0 .. k_{n-1}]ᵀ) · [v_0 .. v_{n-1}],

computed as a stream over the ring: at step t = 0..n-1 rank ``me`` takes
the K/V block of rank ``src = (me - t) mod n`` and folds it into a running
row max ``m``, normalizer ``l`` and accumulator ``acc``, all in float32.
Query head j reads K/V head ``j // (h / h_kv)`` (grouped-query attention,
consecutive groups). Under ``causal``, query position ``me·s + i`` sees key
position ``src·s + j`` only when it is not later.

The wrapper takes one tensor per rank. On CPU tensors it runs the plain
version ``ring_flash_attention_ref``; on CUDA tensors it launches the kernel
on the current stream of their device, without synchronising, or raises.
The dtype chooses the kernel's route: float32 runs on CUDA cores, float16
and bfloat16 on the tensor cores (``wgmma``, P split into two 16-bit
halves). It counts its kernel launches in its ``launches`` attribute and
those of the tensor-core route among them in ``tc_launches``, plain ints.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence

import torch

from ..status import Status, UccError
from . import build

SOURCE = "ring_flash_attn.cu"

#: torch dtype -> dtype code of csrc/ring_flash_attn.cu
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

#: dtypes the kernel runs on the tensor cores
TENSOR_CORE_DTYPES = (torch.float16, torch.bfloat16)

#: largest head dim the kernel takes (its widest register tile)
MAX_HEAD_DIM = 256
#: most ranks the kernel takes: the pointer table travels by value in the
#: launch's parameters (4 pointers a rank)
MAX_RANKS = 64
#: most query heads the kernel takes: the head index is the grid's y, whose
#: extent CUDA caps at 65535
MAX_HEADS = 65535


def check_args(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
               vs: Sequence[torch.Tensor]):
    """(n, h, h_kv, s, d) of per-rank blocks q (h, s, d) and k, v (h_kv, s,
    d), after refusing what the kernel does not take: ERR_INVALID_PARAM for
    lists of unequal length, tensors that are not 3-d, contiguous, of one
    dtype and one device, for shapes that differ between ranks, for h not a
    multiple of h_kv and for empty blocks; ERR_NOT_SUPPORTED for dtypes
    other than float32, float16 and bfloat16, for a head dim above
    MAX_HEAD_DIM, for more than MAX_HEADS query heads and for more than
    MAX_RANKS ranks."""
    n = len(qs)
    if n == 0 or len(ks) != n or len(vs) != n:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ring attention takes one q, k and v per rank, got "
                       f"{len(qs)}, {len(ks)} and {len(vs)}")
    if n > MAX_RANKS:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring attention takes at most {MAX_RANKS} ranks, "
                       f"got {n}")
    q0, k0 = qs[0], ks[0]
    for t in (*qs, *ks, *vs):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "ring attention blocks must be 3-d tensors "
                           "(heads, seq_local, head_dim)")
        if t.dtype != q0.dtype or t.device != q0.device or \
                not t.is_contiguous():
            raise UccError(Status.ERR_INVALID_PARAM,
                           "ring attention blocks must be contiguous tensors "
                           "of one dtype and one device")
    if q0.dtype not in DTYPE_CODES:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring attention does not implement {q0.dtype}")
    h, s, d = q0.shape
    h_kv = k0.shape[0]
    if any(q.shape != q0.shape for q in qs) or \
            any(t.shape != (h_kv, s, d) for t in (*ks, *vs)):
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ring attention shapes: q {tuple(q0.shape)} and k/v "
                       f"{tuple(k0.shape)} must agree on every rank, with "
                       f"k/v of one shape")
    if h_kv == 0 or h % h_kv != 0 or s == 0 or d == 0:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ring attention shapes: {h} q heads over {h_kv} k/v "
                       f"heads, seq_local {s}, head_dim {d}")
    if d > MAX_HEAD_DIM:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring attention takes a head dim of at most "
                       f"{MAX_HEAD_DIM}, got {d}")
    if h > MAX_HEADS:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring attention takes at most {MAX_HEADS} query "
                       f"heads, got {h}")
    return n, h, h_kv, s, d


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def ring_shard(q: torch.Tensor, ks: Sequence[torch.Tensor],
               vs: Sequence[torch.Tensor], me: int, scale: float,
               causal: bool) -> torch.Tensor:
    """Rank ``me``'s output of the ring: ``_xla_ring_shard`` of the JAX
    package on that rank, in plain torch ops (differentiable). At step t
    the rank holds the K/V block of rank (me - t) mod n, which is where
    ``ops.ring_shift`` would have carried it, and folds it into a running
    max, normalizer and accumulator in float32 with the kernel's causal
    mask. Under ``causal`` a step whose keys all lie after the rank's
    queries (src > me) changes nothing (p = 0, correction 1) and is
    skipped, as the kernel skips it. The backward of
    ``fused_attention.ring_flash_attention`` differentiates it, one rank
    at a time."""
    n = len(ks)
    h, s, d = q.shape
    h_kv = ks[0].shape[0]
    g = h // h_kv
    dev = q.device
    # GQA fold, as the kernel's: q (h, s, d) -> (h_kv, g*s, d), row r =
    # (group r // s, position r % s); only the h_kv K/V heads travel
    qf = q.float().reshape(h_kv, g * s, d) * scale
    iq = torch.arange(g * s, device=dev).remainder(s)[:, None]
    ik = torch.arange(s, device=dev)[None, :]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    zero = torch.tensor(0.0, device=dev)
    acc = torch.zeros(h_kv, g * s, d, device=dev)
    m_run = torch.full((h_kv, g * s), float("-inf"), device=dev)
    l_run = torch.zeros(h_kv, g * s, device=dev)
    for t in range(n):
        src = (me - t) % n
        if causal and src > me:
            continue
        sc = torch.einsum("hqd,hkd->hqk", qf, ks[src].float())
        if causal:
            mask = (me * s + iq) >= (src * s + ik)
            sc = torch.where(mask[None], sc, neg_inf)
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        # exp(-inf - -inf) would be NaN; fully masked rows keep p = 0
        safe_m = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(torch.where(torch.isfinite(sc),
                                  sc - safe_m[..., None], neg_inf))
        corr = torch.where(torch.isfinite(m_run),
                           torch.exp(m_run - safe_m), zero)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "hqk,hkd->hqd", p, vs[src].float())
        m_run = m_new
    out = acc / torch.where(l_run == 0.0, torch.ones_like(l_run),
                            l_run)[..., None]
    return out.reshape(h, s, d).to(q.dtype)


def ring_flash_attention_ref(qs: Sequence[torch.Tensor],
                             ks: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor], scale: float,
                             causal: bool) -> List[torch.Tensor]:
    """Plain version of the kernel: ``_xla_ring_shard`` of the JAX package
    over per-rank lists, ``ring_shard`` of every rank. Torch ops only; the
    tests and ``chip_smoke.py`` hold the kernel against it."""
    return [ring_shard(q, ks, vs, me, scale, causal)
            for me, q in enumerate(qs)]


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.ucc_ring_flash_attn.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.ucc_ring_flash_attn.restype = ctypes.c_int
        lib.ucc_ring_flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.ucc_ring_flash_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def default_scale(d: int) -> float:
    """``1/sqrt(head_dim)``, the JAX package's default."""
    return 1.0 / math.sqrt(d)


def ring_flash_attention_fwd(qs: Sequence[torch.Tensor],
                             ks: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor], scale: float,
                             causal: bool) -> List[torch.Tensor]:
    """Ring attention of every rank's block: new output tensors (h, s, d),
    one per rank, in the dtype of q. ``scale`` multiplies q (after its cast
    to float32) before the scores; the tensor-core route multiplies the
    scores, which differs by float32 rounding."""
    n, h, h_kv, s, d = check_args(qs, ks, vs)
    dev = qs[0].device
    if dev.type == "cpu":
        return ring_flash_attention_ref(qs, ks, vs, float(scale),
                                        bool(causal))
    if dev.type != "cuda":
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring attention runs on cuda or cpu tensors, not "
                       f"{dev.type}")
    outs = [torch.empty_like(q) for q in qs]
    lib = _library()
    ptrs = (ctypes.c_void_p * (4 * n))(
        *[t.data_ptr() for t in (*qs, *ks, *vs, *outs)])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ucc_ring_flash_attn(
            DTYPE_CODES[qs[0].dtype], ptrs, n, h, h_kv, s, d, float(scale),
            int(bool(causal)), stream)
    if rc != 0:
        what = lib.ucc_ring_flash_attn_error_string(rc).decode()
        raise UccError(Status.ERR_NO_RESOURCE,
                       f"ring attention launch failed: CUDA error {rc} "
                       f"({what})")
    ring_flash_attention_fwd.launches += 1
    if qs[0].dtype in TENSOR_CORE_DTYPES:
        ring_flash_attention_fwd.tc_launches += 1
    return outs


ring_flash_attention_fwd.launches = 0
ring_flash_attention_fwd.tc_launches = 0
