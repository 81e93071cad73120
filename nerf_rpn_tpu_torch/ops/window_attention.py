"""Window attention from the packed qkv projection: kernels K1 and K2.

Port of ``fused_qkv_window_attention`` (``nerf_rpn_tpu/ops/window_attention.py
:132-187``) and of the backward of ``flash_window_attention`` (``:313-478``).
Per window w and head h::

    out[w, :, hD:(h+1)D] = softmax(q k^T * D^-1/2 + bias[h] (+ mask[w % nW])) v

with ``qkv`` laid out ``[q heads | k heads | v heads]`` along its last axis.
The shift mask is taken as ``(nW, N, N)`` and indexed by ``w % nW`` (windows
are batch-major), which is the tiled ``(B*nW, N, N)`` mask of the JAX
package without the tile.

``window_attention`` runs the CUDA kernel K1 (``csrc/window_attention.cu``)
on CUDA tensors and the plain twin ``window_attention_reference`` on CPU
tensors; ``window_attention_backward`` does the same with kernel K2
(``csrc/window_attention_bwd.cu``) and ``window_attention_backward_reference``.
``WindowAttention`` ties them together as one autograd function (K1 forward,
K2 backward; the mask is a constant and gets no gradient).  Nothing falls
back from a kernel to its twin.
"""

from __future__ import annotations

import torch

from nerf_rpn_tpu_torch import kernels

N_TOKENS = 64
MAX_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
           num_heads: int) -> tuple[int, int, int]:
    if qkv.dim() != 3 or qkv.shape[1] != N_TOKENS or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (W, {N_TOKENS}, 3C), got {tuple(qkv.shape)}")
    w, n, c3 = qkv.shape
    c = c3 // 3
    if c % num_heads:
        raise ValueError(f"C={c} is not divisible by num_heads={num_heads}")
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"bias must be ({num_heads}, {n}, {n}), got {tuple(bias.shape)}")
    nw = w
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n) or w % mask.shape[0]:
            raise ValueError(
                f"mask must be (nW, {n}, {n}) with W={w} a multiple of nW, "
                f"got {tuple(mask.shape)}")
        nw = mask.shape[0]
    return w, c, nw


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: torch.Tensor | None,
                               num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (same arguments, same rounding:
    q scaled in its own dtype, f32 logits and softmax, P cast to the input
    dtype, f32 accumulation)."""
    w, c, nw = _check(qkv, bias, mask, num_heads)
    n = qkv.shape[1]
    d = c // num_heads
    scale = torch.tensor(d ** -0.5, dtype=qkv.dtype, device=qkv.device)
    q, k, v = qkv.reshape(w, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    s = s + bias.float()[None]
    if mask is not None:
        s = s.reshape(w // nw, nw, num_heads, n, n) + mask.float()[None, :, None]
        s = s.reshape(w, num_heads, n, n)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(qkv.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(w, n, c)


def _kernel_args(qkv: torch.Tensor, bias: torch.Tensor,
                 mask: torch.Tensor | None, num_heads: int):
    """Checks of a kernel call; f32 contiguous bias and mask on qkv's device."""
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    w, c, nw = _check(qkv, bias, mask, num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"window attention kernels take f32 or bf16, got {qkv.dtype}")
    if c // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"head width {c // num_heads} > {MAX_HEAD_DIM}")
    bias = bias.to(device=qkv.device, dtype=torch.float32).contiguous()
    if mask is not None:
        mask = mask.to(device=qkv.device, dtype=torch.float32).contiguous()
    return w, c, nw, bias, mask


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor | None, num_heads: int) -> torch.Tensor:
    """(W, 64, 3C) qkv, (H, 64, 64) bias, (nW, 64, 64) mask or None ->
    (W, 64, C) in the qkv dtype, heads in lane order.

    CPU tensors take the plain twin; CUDA tensors launch kernel K1 or raise.
    """
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, num_heads)
    w, c, nw, bias, mask = _kernel_args(qkv, bias, mask, num_heads)
    qkv = qkv.contiguous()
    out = torch.empty((w, qkv.shape[1], c), dtype=qkv.dtype, device=qkv.device)
    kernels.launch(
        "window_attention_fwd",
        qkv.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        w, num_heads, c, nw, _DTYPE_CODES[qkv.dtype],
        (c // num_heads) ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    return out


def window_attention_backward_reference(
        qkv: torch.Tensor, dout: torch.Tensor, bias: torch.Tensor,
        mask: torch.Tensor | None, num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel K2, in the order of operations of the
    TPU kernel ``_flash_bwd_kernel``: p recomputed in f32 from q scaled in
    its own dtype; ``dv = round(p)^T dout``; ``ds = p (dp - rowsum(dp p))``
    in f32; ``dq = (round(ds) k) * scale``, ``dk = round(ds)^T qs``, each
    product accumulated in f32 and rounded to the qkv dtype; ``dbias`` the
    f32 sum of the unrounded ``ds`` over windows.

    Returns ``(dqkv (W, 64, 3C) in the qkv dtype, dbias (H, 64, 64) f32)``.
    """
    w, c, nw = _check(qkv, bias, mask, num_heads)
    if tuple(dout.shape) != (w, qkv.shape[1], c):
        raise ValueError(f"dout must be ({w}, {qkv.shape[1]}, {c}), got {tuple(dout.shape)}")
    n = qkv.shape[1]
    d = c // num_heads
    dt = qkv.dtype
    scale = d ** -0.5
    q, k, v = qkv.reshape(w, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    qs = (q * torch.tensor(scale, dtype=dt, device=qkv.device)).float()
    k, v = k.float(), v.float()
    g = dout.to(dt).reshape(w, n, num_heads, d).transpose(1, 2).float()
    s = torch.matmul(qs, k.transpose(-1, -2)) + bias.float()[None]
    if mask is not None:
        s = s.reshape(w // nw, nw, num_heads, n, n) + mask.float()[None, :, None]
        s = s.reshape(w, num_heads, n, n)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g).to(dt)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(dt).float()
    dq = (torch.matmul(dsb, k) * scale).to(dt)
    dk = torch.matmul(dsb.transpose(-1, -2), qs).to(dt)
    # (3, W, H, N, D) -> (W, N, 3, H, D): the [q | k | v] lane layout
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(w, n, 3 * c)
    return dqkv, ds.sum(dim=0)


# blocks of the K2 grid to aim for: enough (window group, head) blocks to
# fill 132 SMs several times over, few enough that the f32 dbias partials
# (one (64, 64) tile per block) stay small
_BWD_BLOCKS = 1024


def backward_groups(w: int, num_heads: int) -> tuple[int, int]:
    """(windows per group, number of groups) of the K2 grid for W windows."""
    per = -(-w // min(w, max(1, _BWD_BLOCKS // num_heads)))
    return per, -(-w // per)


def window_attention_backward(qkv: torch.Tensor, dout: torch.Tensor,
                              bias: torch.Tensor, mask: torch.Tensor | None,
                              num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, 64, 3C) qkv, (W, 64, C) dout in the qkv dtype, (H, 64, 64)
    bias, (nW, 64, 64) mask or None -> (dqkv in the qkv dtype, dbias f32).

    CPU tensors take the plain twin; CUDA tensors launch kernel K2 (the
    per-group kernel and its fixed-order dbias reduction) or raise.
    """
    if qkv.device.type == "cpu":
        return window_attention_backward_reference(qkv, dout, bias, mask, num_heads)
    w, c, nw, bias, mask = _kernel_args(qkv, bias, mask, num_heads)
    if tuple(dout.shape) != (w, qkv.shape[1], c) or dout.device != qkv.device:
        raise ValueError(f"dout must be ({w}, {qkv.shape[1]}, {c}) on {qkv.device}, "
                         f"got {tuple(dout.shape)} on {dout.device}")
    qkv = qkv.contiguous()
    dout = dout.to(qkv.dtype).contiguous()
    per, n_groups = backward_groups(w, num_heads)
    n = qkv.shape[1]
    dqkv = torch.empty_like(qkv)
    part = torch.empty((n_groups, num_heads, n, n), dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((num_heads, n, n), dtype=torch.float32, device=qkv.device)
    kernels.launch(
        "window_attention_bwd",
        qkv.data_ptr(), dout.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        dqkv.data_ptr(), part.data_ptr(), dbias.data_ptr(),
        w, num_heads, c, nw, per, _DTYPE_CODES[qkv.dtype],
        (c // num_heads) ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    return dqkv, dbias


class WindowAttention(torch.autograd.Function):
    """Differentiable window attention: K1 forward, K2 backward (their
    twins on CPU tensors).  ``apply(qkv, bias, mask, num_heads)``; the
    bias is cast to a contiguous f32 tensor once, and the backward sees the
    tensors the forward saw; the mask is a constant of the window geometry
    and gets no gradient, as the JAX VJP gives it zeros."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads):
        bias = bias.float().contiguous()
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, bias, mask)
        return window_attention(qkv, bias, mask, num_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_backward(qkv, dout, bias, mask, ctx.num_heads)
        return dqkv, dbias, None, None
