"""Fused bias-free attention as hand-written CUDA kernels (port of
``simseg_tpu/ops/flash_attention.py``: ``flash_mha``, ``flash_mha_train``,
``flash_mha_rowblock`` and ``flash_mha_stream``).

``flash_mha(qh, kh, vh)`` takes (B, T, H, hd) tensors with q pre-scaled by
hd^-1/2 and returns softmax(q k^T) v in the same layout and q's dtype. On a
CUDA tensor it launches ``csrc/flash_attention.cu`` or raises — there is no
fallback; on a CPU tensor it runs ``flash_mha_plain``. Its backward
recomputes through the plain version, as the JAX ``custom_vjp`` does
(:179-198).

``flash_mha_train`` is the training form (JAX :201-221): the same forward,
which on the card also writes each row's log-sum-exp, and a backward that
is a kernel too, ``csrc/flash_attention_bwd.cu`` (TPU ``_mha_bwd_pallas``).
On the CPU both halves are plain: ``flash_mha_plain`` forward and
``flash_mha_train_bwd_plain`` backward.

``flash_mha_rowblock`` and ``flash_mha_stream`` are the long-sequence
lanes (JAX :536-558, :788-810). The TPU needed two more kernel pairs there
only because the whole (T, T) tile stops fitting VMEM past T = 1536; the
two CUDA kernels above stream 64-row k/v tiles through shared memory and
have no T ceiling, so on the card both lanes launch them: the forward
(with the log-sum-exp only when the call is differentiated, as the JAX
primal path skips it) and the FlashAttention-2 backward, whose delta =
rowsum(g * o) from the forward's output is the TPU rowblock and stream
backward's own. On the CPU each lane runs its own plain pair:
``flash_mha_rowblock_plain`` (the whole-T ``flash_mha_plain``: the TPU
row-block kernel normalises p before its bf16 cast, as the whole-T one
does) or ``flash_mha_stream_plain`` forward, and ``flash_mha_long_bwd_plain``
backward.

Counts: ``LAUNCHES`` forward kernel launches, ``BWD_LAUNCHES`` backward
ones (one per wrapper call each, on the card), ``LANE_CALLS[lane]`` the
forward launches of each lane ("flash", "train", "rowblock", "stream").

``flash_supported``, ``flash_train_supported``, ``flash_rowblock_supported``
and ``flash_stream_supported`` are the JAX gates, copied as they are: their
bands (1024 <= T <= 1536 whole-T; 1536 < T <= 4096 row-block in training,
1680 < T <= 4096 in inference; T > 4096 streaming) were measured on a TPU,
not on this card, and are kept for parity.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from simseg_tpu_torch.ops import cuda_build

__all__ = ["BWD_LAUNCHES", "LANE_CALLS", "LAUNCHES", "flash_mha",
           "flash_mha_long_bwd_plain", "flash_mha_plain", "flash_mha_rowblock",
           "flash_mha_rowblock_plain", "flash_mha_stream",
           "flash_mha_stream_plain", "flash_mha_train",
           "flash_mha_train_bwd", "flash_mha_train_bwd_plain",
           "flash_rowblock_supported", "flash_stream_supported",
           "flash_supported", "flash_train_supported"]

_NAME = "flash_attention"  # csrc/flash_attention.cu
_BWD_NAME = "flash_attention_bwd"  # csrc/flash_attention_bwd.cu
_HEAD_DIMS = (64, 128, 192, 256)  # the kernel's template instances

# the whole-T TPU kernel's VMEM ceiling (JAX ``_MAX_T``)
_MAX_T = 1536
# the TPU row-block kernels' k/v-resident ceiling (JAX ``_ROWBLOCK_MAX_T``)
_ROWBLOCK_MAX_T = 4096
# the TPU's measured in-tower crossover of row-block against einsum in
# inference (JAX ``_ROWBLOCK_MIN_INFER``)
_ROWBLOCK_MIN_INFER = 1680

# launches of the forward kernel (one per forward call on the card)
LAUNCHES = 0
# launches of the backward kernels (one per flash_mha_train, rowblock or
# stream backward call on the card: its delta, dq and dk/dv passes)
BWD_LAUNCHES = 0
# forward launches by lane
LANE_CALLS = {"flash": 0, "train": 0, "rowblock": 0, "stream": 0}


def flash_supported(tq: int, tk: int, hd: int, dtype, attention_bias) -> bool:
    """JAX ``flash_supported`` (``simseg_tpu/ops/flash_attention.py:838-861``):
    no bias, not float32, 1024 <= Tq, Tk <= 1536, hd a multiple of 64 up to
    256."""
    if attention_bias is not None:
        return False
    if dtype == torch.float32:
        return False
    if not (1024 <= tq <= _MAX_T and 1024 <= tk <= _MAX_T):
        return False
    return hd % 64 == 0 and hd <= 256


def flash_train_supported(b: int, h: int, tq: int, tk: int, hd: int, dtype,
                          attention_bias) -> bool:
    """JAX ``flash_train_supported`` (``simseg_tpu/ops/flash_attention.py
    :813-835``): the gate of ``flash_mha_train`` in a differentiated
    region — no bias, not float32, hd a multiple of 64 up to 256,
    self-attention (Tq == Tk) with 1024 <= T <= 1536."""
    if attention_bias is not None or dtype == torch.float32:
        return False
    if hd % 64 != 0 or hd > 256:
        return False
    if tq != tk:
        return False
    return 1024 <= tq <= _MAX_T


def _long_t_eligible(tq: int, tk: int, hd: int, dtype, attention_bias) -> bool:
    """JAX ``_long_t_eligible`` (:864-870): no bias, not float32, hd a
    multiple of 64 up to 256, self-attention."""
    if attention_bias is not None or dtype == torch.float32:
        return False
    if hd % 64 != 0 or hd > 256:
        return False
    return tq == tk


def flash_rowblock_supported(tq: int, tk: int, hd: int, dtype,
                             attention_bias, training: bool = False) -> bool:
    """JAX ``flash_rowblock_supported`` (:882-892): past the whole-T
    ceiling up to 4096, entered at 1536 by a differentiated call and at
    1680 in inference."""
    if not _long_t_eligible(tq, tk, hd, dtype, attention_bias):
        return False
    floor = _MAX_T if training else _ROWBLOCK_MIN_INFER
    return floor < tq <= _ROWBLOCK_MAX_T


def flash_stream_supported(tq: int, tk: int, hd: int, dtype,
                           attention_bias) -> bool:
    """JAX ``flash_stream_supported`` (:895-904): T > 4096, in inference
    and in training."""
    if not _long_t_eligible(tq, tk, hd, dtype, attention_bias):
        return False
    return tq > _ROWBLOCK_MAX_T


def flash_mha_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    with_lse: bool = False):
    """The kernel's function in plain PyTorch (JAX ``_reference_mha``,
    :167-176): float32 scores from the operands, max-subtracted softmax in
    float32, p cast to v's dtype, p v accumulated in float32, output in q's
    dtype; with ``with_lse`` also the (B, H, Tq) f32 log-sum-exp. The TPU
    row-block kernel (``_rowblock_fwd_kernel``, :616-633) computes the same
    function with the same casts, so this is the row-block lane's plain
    forward too."""
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", (e / l).to(vh.dtype).float(),
                       vh.float()).to(qh.dtype)
    return (out, (m + torch.log(l))[..., 0]) if with_lse else out


flash_mha_rowblock_plain = flash_mha_plain


def flash_mha_train_bwd_plain(qh: torch.Tensor, kh: torch.Tensor,
                              vh: torch.Tensor, g: torch.Tensor):
    """The backward kernel's function in plain PyTorch, cast for cast as
    JAX ``_mha_bwd_kernel`` (:91-124): p = softmax(q k^T) recomputed in
    float32; dv = bf16(p)^T g, dp = g v^T, ds = bf16(p (dp - rowsum(p dp))),
    dq = ds k, dk = ds^T q, every product accumulated in float32, each
    gradient in its input's dtype. Returns (dq, dk, dv) as (B, T, H, hd)."""
    g = g.to(qh.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pc = p.to(vh.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pc, g.float()).to(vh.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), vh.float())
    ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True))).to(qh.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh.float()).to(qh.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh.float()).to(kh.dtype)
    return dq, dk, dv


def flash_mha_stream_plain(qh: torch.Tensor, kh: torch.Tensor,
                           vh: torch.Tensor, with_lse: bool = False):
    """The streaming forward in plain PyTorch after JAX
    ``_stream_fwd_kernel`` (:283-327): p is the UNnormalised e = exp(s - m)
    cast to v's dtype, e v is accumulated in float32 and divided by l =
    rowsum(e) at the end. The row's global max stands in for the kernel's
    running max over 512-key tiles: the two differ at the bf16 rounding of
    e; with ``with_lse`` also the (B, H, Tq) f32 log-sum-exp."""
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", e.to(vh.dtype).float(), vh.float())
    out = (acc / l).transpose(1, 2).to(qh.dtype)
    return (out, (m + torch.log(l))[..., 0]) if with_lse else out


def flash_mha_long_bwd_plain(qh: torch.Tensor, kh: torch.Tensor,
                             vh: torch.Tensor, out: torch.Tensor,
                             g: torch.Tensor, lse: torch.Tensor):
    """The row-block and streaming backward in plain PyTorch, cast for cast
    as JAX ``_rowblock_dq_kernel`` / ``_rowblock_dkdv_kernel`` (:674-714;
    the streaming pair is the same math): p = exp(s - lse) from the
    forward's (B, H, Tq) f32 log-sum-exp, delta = rowsum(g * o) in float32
    from the forward's output o, dv = bf16(p)^T g, dp = g v^T, ds =
    bf16(p (dp - delta)), dq = ds k, dk = ds^T q, products accumulated in
    float32, each gradient in its input's dtype. Returns (dq, dk, dv).
    (The whole-T ``flash_mha_train_bwd_plain`` takes delta from rowsum(p
    dp) instead.)"""
    g = g.to(qh.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(),
                      g.float()).to(vh.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), vh.float())
    delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)  # (B, H, Tq)
    ds = (p * (dp - delta[..., None])).to(qh.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh.float()).to(qh.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh.float()).to(kh.dtype)
    return dq, dk, dv


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.flash_attention_fwd_bf16
    fn.argtypes = [p, p, p, p, p,         # q, k, v, o, lse (or null)
                   i, i, i, i, i,         # B, Tq, Tk, H, hd
                   p, p]                  # strides (12 int64), stream
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_BWD_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.flash_attention_bwd_bf16
    fn.argtypes = [p, p, p, p, p, p,      # q, k, v, o, g, lse
                   p, p, p, p,            # delta scratch, dq, dk, dv
                   i, i, i, i, i,         # B, Tq, Tk, H, hd
                   p, p]                  # strides (24 int64), stream
    fn.restype = ctypes.c_int
    return lib


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it: unit head-dim stride, 16-byte aligned
    rows and strides (the backward's TMA tensor maps take nothing else),
    and no broadcast (zero-stride) batch, token or head dimension. The
    ViT's q, k, v already are (views into the fused qkv output); anything
    else is copied once, into a fresh (aligned) allocation: a contiguous
    view at a misaligned offset is copied too."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 and (s > 0 or n == 1)
                    for s, n in zip(x.stride()[:3], x.shape[:3]))):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_operands(qh: torch.Tensor, **others: torch.Tensor) -> None:
    """What the kernels take: bfloat16, hd in 64/128/192/256, and k, v (and
    o, g) shaped like q with Tk rows, on q's device."""
    b, tq, h, hd = qh.shape
    tk = others["k"].shape[1]
    for name, x in others.items():
        want = (b, tq if name in ("o", "g") else tk, h, hd)
        if x.shape != want:
            raise ValueError(f"{name} must be {want}, got {tuple(x.shape)}")
        if x.dtype != qh.dtype or x.device != qh.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; q is "
                             f"{qh.dtype} on {qh.device}")
    if qh.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {qh.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd}; the kernel takes {_HEAD_DIMS}")


def _strides(*xs: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(s for x in xs for s in x.stride()[:3]))


def _launch(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
            with_lse: bool = False, lane: str = "flash"):
    """The forward kernel -> out, or (out, lse) with the (B, H, Tq) f32
    per-row log-sum-exp when ``with_lse``; counted under ``lane``."""
    _check_operands(qh, k=kh, v=vh)
    b, tq, h, hd = qh.shape
    lib = _library()
    qh, kh, vh = (_kernel_operand(x) for x in (qh, kh, vh))
    out = torch.empty((b, tq, h, hd), dtype=qh.dtype, device=qh.device)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=qh.device)
           if with_lse else None)
    strides = _strides(qh, kh, vh, out)
    status = lib.flash_attention_fwd_bf16(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, tq, kh.shape[1], h, hd,
        ctypes.addressof(strides),
        torch.cuda.current_stream(qh.device).cuda_stream)
    cuda_build.check_status(lib, _NAME, "flash_attention_fwd_bf16", status)
    global LAUNCHES
    LAUNCHES += 1
    LANE_CALLS[lane] += 1
    return (out, lse) if with_lse else out


def flash_mha_train_bwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                        out: torch.Tensor, g: torch.Tensor, lse: torch.Tensor):
    """The backward kernel: (dq, dk, dv) of ``flash_mha_train``,
    ``flash_mha_rowblock`` or ``flash_mha_stream`` from the forward's
    inputs, its output ``out`` and its (B, H, Tq) f32 ``lse``, and
    g = dL/d out (cast to q's dtype, as the JAX backward does). CUDA
    tensors only: there is no plain fallback here."""
    if qh.device.type != "cuda":
        raise ValueError(f"the backward kernel runs on CUDA, got {qh.device}")
    g = g.to(qh.dtype)
    _check_operands(qh, k=kh, v=vh, o=out, g=g)
    b, tq, h, hd = qh.shape
    tk = kh.shape[1]
    if lse.shape != (b, h, tq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, h, tq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    lib = _bwd_library()
    qh, kh, vh, out, g = (_kernel_operand(x) for x in (qh, kh, vh, out, g))
    lse = lse.contiguous()
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=qh.device)
    dq = torch.empty((b, tq, h, hd), dtype=qh.dtype, device=qh.device)
    dk = torch.empty((b, tk, h, hd), dtype=qh.dtype, device=qh.device)
    dv = torch.empty((b, tk, h, hd), dtype=qh.dtype, device=qh.device)
    strides = _strides(qh, kh, vh, out, g, dq, dk, dv)
    status = lib.flash_attention_bwd_bf16(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, tq, tk, h, hd,
        ctypes.addressof(strides),
        torch.cuda.current_stream(qh.device).cuda_stream)
    cuda_build.check_status(lib, _BWD_NAME, "flash_attention_bwd_bf16", status)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    plain version's gradients, recomputed from q, k, v (flash-style: no
    (T, T) tensor is saved)."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        ctx.save_for_backward(qh, kh, vh)
        if qh.device.type == "cpu":
            return flash_mha_plain(qh, kh, vh)
        if qh.device.type != "cuda":
            raise ValueError(f"no attention kernel for device {qh.device}")
        return _launch(qh, kh, vh)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
            out = flash_mha_plain(*leaves)
        return torch.autograd.grad(out, leaves, g)


def flash_mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """Attention on (B, T, H, hd) inputs, q pre-scaled by hd^-1/2 ->
    (B, Tq, H, hd) in q's dtype (kernel: bfloat16, hd in 64/128/192/256)."""
    if qh.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(qh.shape)}")
    return _FlashMHA.apply(qh, kh, vh)


class _FlashMHATrain(torch.autograd.Function):
    """Forward: the kernel with its log-sum-exp (CUDA) or the plain version
    (CPU). Backward: the backward kernel from q, k, v, the output and the
    log-sum-exp (CUDA), or ``flash_mha_train_bwd_plain`` (CPU)."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        if qh.device.type == "cpu":
            ctx.save_for_backward(qh, kh, vh)
            return flash_mha_plain(qh, kh, vh)
        if qh.device.type != "cuda":
            raise ValueError(f"no attention kernel for device {qh.device}")
        out, lse = _launch(qh, kh, vh, with_lse=True, lane="train")
        ctx.save_for_backward(qh, kh, vh, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if len(ctx.saved_tensors) == 3:
            return flash_mha_train_bwd_plain(*ctx.saved_tensors, g)
        qh, kh, vh, out, lse = ctx.saved_tensors
        return flash_mha_train_bwd(qh, kh, vh, out, g, lse)


def flash_mha_train(qh: torch.Tensor, kh: torch.Tensor,
                    vh: torch.Tensor) -> torch.Tensor:
    """``flash_mha`` for a differentiated call: both passes are kernels on
    the card (JAX ``flash_mha_train``). Saves q, k, v, the output and the
    (B, H, Tq) f32 log-sum-exp; nothing of size T x T."""
    if qh.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(qh.shape)}")
    return _FlashMHATrain.apply(qh, kh, vh)


_LONG_PLAIN = {"rowblock": flash_mha_rowblock_plain,
               "stream": flash_mha_stream_plain}


class _LongMHA(torch.autograd.Function):
    """A long-sequence lane ("rowblock" or "stream"). Forward: the kernel
    (CUDA), with the log-sum-exp only when an input needs a gradient, or
    the lane's plain forward (CPU). Backward: the backward kernel (CUDA) or
    ``flash_mha_long_bwd_plain`` (CPU), from q, k, v, the output and the
    log-sum-exp; nothing of size T x T is saved."""

    @staticmethod
    def forward(ctx, qh, kh, vh, lane):
        differentiated = any(ctx.needs_input_grad[:3])
        if qh.device.type == "cpu":
            out, lse = _LONG_PLAIN[lane](qh, kh, vh, with_lse=True)
        elif qh.device.type == "cuda":
            res = _launch(qh, kh, vh, with_lse=differentiated, lane=lane)
            out, lse = res if differentiated else (res, None)
        else:
            raise ValueError(f"no attention kernel for device {qh.device}")
        if differentiated:
            ctx.save_for_backward(qh, kh, vh, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, out, lse = ctx.saved_tensors
        if qh.device.type == "cpu":
            grads = flash_mha_long_bwd_plain(qh, kh, vh, out, g, lse)
        else:
            grads = flash_mha_train_bwd(qh, kh, vh, out, g, lse)
        return (*grads, None)


def _long(qh, kh, vh, lane):
    if qh.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(qh.shape)}")
    return _LongMHA.apply(qh, kh, vh, lane)


def flash_mha_rowblock(qh: torch.Tensor, kh: torch.Tensor,
                       vh: torch.Tensor) -> torch.Tensor:
    """The row-block lane (JAX ``flash_mha_rowblock``, 1536 or 1680 < T <=
    4096): (B, T, H, hd) -> (B, Tq, H, hd) in q's dtype; the forward and
    backward kernels on the card, ``flash_mha_rowblock_plain`` and
    ``flash_mha_long_bwd_plain`` on the CPU."""
    return _long(qh, kh, vh, "rowblock")


def flash_mha_stream(qh: torch.Tensor, kh: torch.Tensor,
                     vh: torch.Tensor) -> torch.Tensor:
    """The streaming lane (JAX ``flash_mha_stream``, T > 4096): the same
    kernels on the card, ``flash_mha_stream_plain`` and
    ``flash_mha_long_bwd_plain`` on the CPU."""
    return _long(qh, kh, vh, "stream")
