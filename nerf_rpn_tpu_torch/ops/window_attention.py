"""Window attention: kernels K1, K2 and K4.

Port of ``fused_qkv_window_attention`` (``nerf_rpn_tpu/ops/window_attention.py
:132-187``), of the backward of ``flash_window_attention`` (``:313-478``) and
of ``fused_window_attention`` (``:240-283``).  K1 and K2, per window w and
head h::

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
K2 backward; the mask is a constant and gets no gradient).

``fused_window_attention`` (kernel K4, the same source as K1) takes q, k, v
as ``(W, H, 64, D)`` views with any strides but a contiguous D axis, and the
shift mask as a ``(P, 64, 64)`` table of distinct patterns with a pattern id
per window; its twin is ``fused_window_attention_reference``.  Nothing falls
back from a kernel to its twin.

The K1/K4 kernel runs one block per (window, group of G heads), block b
taking window ``b // (H / G)`` and heads from ``(b % (H / G)) * G``;
:func:`head_group` picks G.  The K2 kernel runs one block per (run of
windows, head), block b taking head ``b % H`` and the windows
:func:`backward_windows` gives run ``b // H``; :func:`backward_groups`
picks the number of runs.  Their 16-byte copies need a head width of a
multiple of 16 bytes and, for K4, 16-byte-aligned views.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_rpn_tpu_torch import kernels

N_TOKENS = 64
MAX_HEAD_DIM = 64

# the K1/K4 head-group planner (csrc/window_attention.cu)
SMS = 132                     # streaming multiprocessors of an H100 SXM
MAX_HEAD_GROUP = 8            # copy groups a block can wait on
TILE_SMEM_BUDGET = 64 * 1024  # a block's q/k/v tiles: three blocks or more an SM


def tile_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory of one head's q, k and v tiles in the K1/K4 kernel:
    64 rows of the head width rounded up to 16, plus 16 bytes of row pad
    (``tile_ld`` in the CUDA source)."""
    ld = -(-head_dim // 16) * 16 + 16 // dtype.itemsize
    return 3 * N_TOKENS * ld * dtype.itemsize


def head_group(w: int, num_heads: int, head_dim: int, dtype: torch.dtype) -> int:
    """Heads per block of the K1/K4 grid for W windows: the largest G that
    divides H, keeps G heads' tiles within ``TILE_SMEM_BUDGET`` and leaves
    at least two blocks per SM (``W * H / G >= 2 * SMS``); 1 where no
    larger G does."""
    per = tile_bytes(head_dim, dtype)
    best = 1
    for g in range(2, min(num_heads, MAX_HEAD_GROUP) + 1):
        if (num_heads % g == 0 and g * per <= TILE_SMEM_BUDGET
                and w * (num_heads // g) >= 2 * SMS):
            best = g
    return best


def _check_vector_width(head_dim: int, dtype: torch.dtype) -> None:
    if head_dim * dtype.itemsize % 16:
        raise ValueError(f"head width {head_dim} in {dtype} is not a multiple of "
                         f"16 bytes, which the kernel's 16-byte copies need")


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
    dtype, f32 accumulation; f64 throughout for f64 input, which the kernel
    does not take)."""
    w, c, nw = _check(qkv, bias, mask, num_heads)
    n = qkv.shape[1]
    d = c // num_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    scale = torch.tensor(d ** -0.5, dtype=qkv.dtype, device=qkv.device)
    q, k, v = qkv.reshape(w, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = torch.matmul((q * scale).to(acc), k.to(acc).transpose(-1, -2))
    s = s + bias.to(acc)[None]
    if mask is not None:
        s = s.reshape(w // nw, nw, num_heads, n, n) + mask.to(acc)[None, :, None]
        s = s.reshape(w, num_heads, n, n)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(qkv.dtype)
    out = torch.matmul(p.to(acc), v.to(acc)).to(qkv.dtype)
    return out.transpose(1, 2).reshape(w, n, c)


def _kernel_args(qkv: torch.Tensor, bias: torch.Tensor,
                 mask: torch.Tensor | None, num_heads: int):
    """Checks of a kernel call; f32 contiguous bias and mask on qkv's device."""
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    w, c, nw = _check(qkv, bias, mask, num_heads)
    if qkv.dtype not in kernels.DTYPE_CODES:
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

    CPU tensors take the plain twin; CUDA tensors launch kernel K1 or raise;
    no windows (a slab of the space axis that holds none) launch nothing.
    """
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, num_heads)
    w, c, nw, bias, mask = _kernel_args(qkv, bias, mask, num_heads)
    d = c // num_heads
    _check_vector_width(d, qkv.dtype)
    if w == 0:
        return qkv.new_empty((0, qkv.shape[1], c))
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on a 16-byte boundary")
    out = torch.empty((w, qkv.shape[1], c), dtype=qkv.dtype, device=qkv.device)
    kernels.launch(
        "window_attention_fwd",
        qkv.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        w, num_heads, c, nw, head_group(w, num_heads, d, qkv.dtype),
        kernels.DTYPE_CODES[qkv.dtype], d ** -0.5,
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
    f32 sum of the unrounded ``ds`` over windows.  f64 input computes in
    f64 throughout (the kernel does not take it).

    Returns ``(dqkv (W, 64, 3C) in the qkv dtype, dbias (H, 64, 64) f32, f64
    for f64 input)``.
    """
    w, c, nw = _check(qkv, bias, mask, num_heads)
    if tuple(dout.shape) != (w, qkv.shape[1], c):
        raise ValueError(f"dout must be ({w}, {qkv.shape[1]}, {c}), got {tuple(dout.shape)}")
    n = qkv.shape[1]
    d = c // num_heads
    dt = qkv.dtype
    acc = torch.promote_types(dt, torch.float32)
    scale = d ** -0.5
    q, k, v = qkv.reshape(w, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    qs = (q * torch.tensor(scale, dtype=dt, device=qkv.device)).to(acc)
    k, v = k.to(acc), v.to(acc)
    g = dout.to(dt).reshape(w, n, num_heads, d).transpose(1, 2).to(acc)
    s = torch.matmul(qs, k.transpose(-1, -2)) + bias.to(acc)[None]
    if mask is not None:
        s = s.reshape(w // nw, nw, num_heads, n, n) + mask.to(acc)[None, :, None]
        s = s.reshape(w, num_heads, n, n)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), g).to(dt)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(dt).to(acc)
    dq = (torch.matmul(dsb, k) * scale).to(dt)
    dk = torch.matmul(dsb.transpose(-1, -2), qs).to(dt)
    # (3, W, H, N, D) -> (W, N, 3, H, D): the [q | k | v] lane layout
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(w, n, 3 * c)
    return dqkv, ds.sum(dim=0)


# the K2 planner (csrc/window_attention_bwd.cu)
BWD_SMEM_PER_SM = 233472  # an H100 SM's 228 KB of shared memory (1 KB more a block)
BWD_MAX_RESIDENT = 3      # blocks an SM holds by registers (__launch_bounds__)


def backward_smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory of a K2 block: two buffers of the q, k, v and dout
    tiles (64 rows of the head width rounded up to 16, plus 16 bytes of
    row pad) and the staged ``round(p)`` and ``round(ds)`` (64 x 72), in
    the qkv dtype, and for bf16 the f32 bias (64 x 64) in per-thread
    slices (``smem_bytes`` in the CUDA source)."""
    ld = -(-head_dim // 16) * 16 + 16 // dtype.itemsize
    bias = N_TOKENS * N_TOKENS * 4 if dtype == torch.bfloat16 else 0
    return (8 * N_TOKENS * ld + 2 * N_TOKENS * (N_TOKENS + 8)) * dtype.itemsize + bias


def backward_resident(head_dim: int, dtype: torch.dtype) -> int:
    """K2 blocks an SM holds at once (``min_blocks`` in the CUDA source)."""
    per_sm = BWD_SMEM_PER_SM // (backward_smem_bytes(head_dim, dtype) + 1024)
    return max(1, min(BWD_MAX_RESIDENT, per_sm))


def backward_groups(w: int, num_heads: int, head_dim: int, dtype: torch.dtype) -> int:
    """Number of window runs of the K2 grid (one block per (run, head)).

    The grid fills the SMs' resident slots in one wave, with two blocks per
    SM at least (``2 * SMS``) where the work allows (``W * H`` blocks when
    that is fewer).  The dbias partials are one (64, 64) f32 tile per
    block, so the grid stays at about one wave."""
    slots = SMS * backward_resident(head_dim, dtype)
    return min(w, max(-(-2 * SMS // num_heads), slots // num_heads))


def backward_windows(run: int, n_groups: int, w: int) -> range:
    """Windows of run ``run`` of ``n_groups`` over W windows, in the order
    the K2 block walks them: runs differ by one window at most."""
    return range(run * w // n_groups, (run + 1) * w // n_groups)


def window_attention_backward(qkv: torch.Tensor, dout: torch.Tensor,
                              bias: torch.Tensor, mask: torch.Tensor | None,
                              num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, 64, 3C) qkv, (W, 64, C) dout in the qkv dtype, (H, 64, 64)
    bias, (nW, 64, 64) mask or None -> (dqkv in the qkv dtype, dbias f32).

    CPU tensors take the plain twin; CUDA tensors launch kernel K2 (one
    block per (window run, head), then the fixed-order sum of the dbias
    partials over runs) or raise.  The kernel's 16-byte copies need a head
    width of a multiple of 16 bytes.
    """
    if qkv.device.type == "cpu":
        return window_attention_backward_reference(qkv, dout, bias, mask, num_heads)
    w, c, nw, bias, mask = _kernel_args(qkv, bias, mask, num_heads)
    if tuple(dout.shape) != (w, qkv.shape[1], c) or dout.device != qkv.device:
        raise ValueError(f"dout must be ({w}, {qkv.shape[1]}, {c}) on {qkv.device}, "
                         f"got {tuple(dout.shape)} on {dout.device}")
    d = c // num_heads
    _check_vector_width(d, qkv.dtype)
    qkv = qkv.contiguous()
    dout = dout.to(qkv.dtype).contiguous()
    if qkv.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("qkv and dout must start on a 16-byte boundary")
    n_groups = backward_groups(w, num_heads, d, qkv.dtype)
    n = qkv.shape[1]
    dqkv = torch.empty_like(qkv)
    part = torch.empty((n_groups, num_heads, n, n), dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((num_heads, n, n), dtype=torch.float32, device=qkv.device)
    kernels.launch(
        "window_attention_bwd",
        qkv.data_ptr(), dout.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        dqkv.data_ptr(), part.data_ptr(), dbias.data_ptr(),
        w, num_heads, c, nw, n_groups, kernels.DTYPE_CODES[qkv.dtype], d ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    return dqkv, dbias


class WindowAttention(torch.autograd.Function):
    """Differentiable window attention: K1 forward, K2 backward (their
    twins on CPU tensors).  ``apply(qkv, bias, mask, num_heads)``; the
    bias is cast to a contiguous f32 tensor (f64 for f64 qkv, on the CPU)
    once, and the backward sees the tensors the forward saw; the mask is a
    constant of the window geometry and gets no gradient, as the JAX VJP
    gives it zeros."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads):
        bias = bias.to(torch.promote_types(qkv.dtype, torch.float32)).contiguous()
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, bias, mask)
        return window_attention(qkv, bias, mask, num_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_backward(qkv, dout, bias, mask, ctx.num_heads)
        return dqkv, dbias, None, None


def _check_k4(q, k, v, bias, mask_table, pattern_ids) -> tuple[int, int, int]:
    if q.dim() != 4 or q.shape[2] != N_TOKENS:
        raise ValueError(f"q must be (W, H, {N_TOKENS}, D), got {tuple(q.shape)}")
    w, h, n, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be ({h}, {n}, {n}), got {tuple(bias.shape)}")
    if mask_table.dim() != 3 or tuple(mask_table.shape[1:]) != (n, n):
        raise ValueError(f"mask_table must be (P, {n}, {n}), got {tuple(mask_table.shape)}")
    if tuple(pattern_ids.shape) != (w,):
        raise ValueError(f"pattern_ids must be ({w},), got {tuple(pattern_ids.shape)}")
    return w, h, mask_table.shape[0]


def fused_window_attention_reference(q, k, v, bias, mask_table, pattern_ids):
    """Plain PyTorch twin of kernel K4, in the arithmetic of the TPU kernel
    ``_kernel``: q, k, v upcast to f32, q scaled in f32, logits + bias +
    ``mask_table[pattern_ids[w]]`` and the softmax in f32, P kept in f32,
    the output cast to the input dtype.  Returns (W, H, 64, D)."""
    _check_k4(q, k, v, bias, mask_table, pattern_ids)
    acc = torch.promote_types(q.dtype, torch.float32)  # f64 input computes in f64
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.to(acc) * scale, k.to(acc).transpose(-1, -2))
    s = s + bias.to(acc)[None]
    s = s + mask_table.to(acc)[pattern_ids.long()][:, None]
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.to(acc)).to(q.dtype)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask_table: torch.Tensor,
                           pattern_ids: torch.Tensor) -> torch.Tensor:
    """(W, H, 64, D) q, k, v views (contiguous D axis), (H, 64, 64) bias,
    (P, 64, 64) mask table, (W,) pattern ids -> (W, H, 64, D) in q's dtype.

    The result is a (W, H, 64, D) view of a (W, 64, H, D) tensor, so that
    ``out.transpose(1, 2).reshape(W, 64, H * D)`` makes no copy.  CPU
    tensors take the plain twin; CUDA tensors launch kernel K4 or raise; no
    windows (a slab of the space axis that holds none) launch nothing.
    """
    if q.device.type == "cpu":
        return fused_window_attention_reference(q, k, v, bias, mask_table, pattern_ids)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    w, h, n_pat = _check_k4(q, k, v, bias, mask_table, pattern_ids)
    if q.dtype not in kernels.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K4 takes f32 or bf16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head width {d} > {MAX_HEAD_DIM}")
    _check_vector_width(d, q.dtype)
    if w == 0:
        return q.new_empty((0, N_TOKENS, h, d)).transpose(1, 2)
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("q, k, v must lie on one device with a contiguous last axis")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("q, k, v must start on 16-byte boundaries with strides "
                             "of a multiple of 16 bytes")
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    table = mask_table.to(device=q.device, dtype=torch.float32).contiguous()
    ids = pattern_ids.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((w, N_TOKENS, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[st for t in (q, k, v, out) for st in t.stride()[:3]])
    kernels.launch(
        "fused_window_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, bias.data_ptr(),
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), w, h, d, n_pat,
        head_group(w, h, d, q.dtype), kernels.DTYPE_CODES[q.dtype], d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
