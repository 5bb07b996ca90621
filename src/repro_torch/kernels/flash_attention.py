"""Forward flash attention (online softmax, GQA, causal and sliding window): CUDA kernel and plain version.

The attention of the LM forward.  On an NVIDIA Hopper card
:func:`flash_attention_cuda` launches the hand-written kernel of
``csrc/flash_attention.cu`` (the port of the Pallas TPU kernel in the JAX
package's ``repro/kernels/flash_attention.py``); :func:`flash_attention_ref`
is its plain PyTorch version, which the CPU takes and against which the
kernel is checked on the card.

Layout as in the JAX package: ``q [B, H, Sq, D]``, ``k, v [B, HK, Sk, D]``
with ``H % HK == 0``; q head ``h`` reads kv head ``h // (H // HK)``.  Query
row ``i`` sits at position ``i + Sk - Sq`` (a suffix of queries attends to
the whole kv axis).  Both compute in fp32 and return ``q.dtype``.

``launches`` counts the kernel launches of this process, and
``launches_by_dtype`` the same launches by input type (``"float32"``: the
fp32 FFMA kernel, ``"bfloat16"``: the tensor-core kernel): both are raised
by one where :func:`flash_attention_cuda` launches a kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

__all__ = ["NEG_INF", "attention_mask", "flash_attention_cuda", "flash_attention_ref", "launches",
           "launches_by_dtype"]

#: kernel launches so far (see the module docstring)
launches = 0
#: the same launches by input type
launches_by_dtype = {"float32": 0, "bfloat16": 0}

#: the finite mask sentinel of the Pallas kernel (never -inf: see the plain version)
NEG_INF = -1e30

_C_FUNCTIONS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_MAX_GRID_YZ = 65535


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool, window: int | None,
                   prefix_len: int | None = None) -> torch.Tensor:
    """``[..., Sq, Sk]`` bool from positions ``[..., Sq]`` and ``[..., Sk]``: which
    (query, key) pairs attend.  Causal keeps ``kpos <= qpos``, the window
    ``kpos > qpos - window``; every query sees a prefix of ``prefix_len`` keys."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    if prefix_len is not None:
        mask |= kp < prefix_len  # prefix-LM: everything sees the prefix
    return mask


def _check_window(window) -> None:
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be None or a positive int, got {window!r}")


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Plain version: materialised fp32 scores, the kernel's masking and divide.

    It follows the kernel, not ``repro/kernels/ref.flash_attention_ref``:
    masked scores take the finite ``-1e30`` and their probabilities are set
    to 0, and a row with no live key (causal with ``Sq > Sk``) divides by 1
    and gives zeros, where the ``-inf`` mask of the JAX package's reference
    gives NaN.  It materialises ``[B, H, Sq, Sk]`` scores, so it is for checks
    and the CPU, not for long sequences on the card.
    """
    _check_window(window)
    B, H, Sq, D = q.shape
    HK, Sk = k.shape[1], k.shape[2]
    if H % HK:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {HK}")
    rep = H // HK
    # q heads hk*rep .. hk*rep + rep - 1 share kv head hk: a group axis, no repeat
    qf = q.float().reshape(B, HK, rep * Sq, D)
    s = torch.matmul(qf, k.float().transpose(-1, -2)).view(B, HK, rep, Sq, Sk)
    s = s * D**-0.5
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    mask = attention_mask(qpos, torch.arange(Sk, device=q.device), causal=causal, window=window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.view(B, HK, rep * Sq, Sk), v.float()).view(B, HK, rep, Sq, D)
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _kernel_function(dtype: torch.dtype):
    fn = getattr(load_library("flash_attention"), _C_FUNCTIONS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = load_library("flash_attention").flash_attention_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as :func:`flash_attention_ref`.

    Takes strided views (the head dim contiguous, rows 16-byte aligned), so
    the transposes of ``[B, S, H, D]`` activations cost no copy; the output
    has q's strides when q is dense.  Runs on PyTorch's current stream and
    does not synchronise.  Raises on what the kernel does not take: a tensor
    off the card, another dtype, a head dim that is not a multiple of 8 in
    [8, 256], mismatched shapes, unaligned or non-unit-stride rows, or a
    launch the CUDA runtime refuses.
    """
    global launches
    _check_window(window)
    dev = q.device
    tensors = (q, k, v)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"flash_attention_cuda needs q, k and v on one CUDA device, got {dev}")
    if q.dtype not in _C_FUNCTIONS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes fp32 or bf16 q, k, v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,H,Sq,D], k = v [B,HK,Sk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, HK, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or HK == 0 or H % HK:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"the kernel takes a head dim that is a multiple of 8 in [8, 256], got {D}")
    if H > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} heads and batch rows, got H={H}, B={B}")
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous and the rows 16-byte "
                             f"aligned (strides {t.stride()})")
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _kernel_function(q.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, HK, Sq, Sk, D,
                strides, int(causal), 0 if window is None else int(window), float(D**-0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {_error_string(rc)} ({rc})")
    launches += 1
    launches_by_dtype[str(q.dtype).replace("torch.", "")] += 1
    return out
