"""The ``space`` axis: a scene's x extent split over ranks.

Counterpart of the JAX package's ``(data, space)`` mesh
(``nerf_rpn_tpu/parallel/mesh.py``: ``make_mesh_2d``, ``grid_sharding``,
``GRID_KEYS``, ``shard_batch``), the path for grids too large for one card.
There GSPMD inserts the convolutions' halo exchanges, the cross-slab
statistics and the all-gathers before propose; here each op that reads
across the x split names the global rows it needs, and one of the exchanges
below brings them.

Paths that take the axis: the anchor RPN's, the FCOS detector's and the
RCNN stage's eval and train steps (``train/steps.py``: ``make_rpn_*_step``
/ ``make_fcos_*_step`` / ``make_rcnn_*_step`` with ``space=``) on every
backbone of the table -- the Swin variants, ``resnet`` / ``resnet_tiny``
and ``vgg_AF`` / ``vgg_EF`` (``level_slabs`` on each).  The RCNN's RoI
align reads any row of a level, so its fine-tune backbone's levels are
gathered whole (:func:`gather_x` with ``sum_grad``) and its train step
splits the sampled RoIs over the space group (:func:`row_block`).

Layout (:func:`make_groups`): ``n_data * n_space`` ranks, rank
``d * n_space + s`` holding data group ``d``'s scenes and the ``s``-th slab
of their x extent -- consecutive ranks form a space group, as
``make_mesh_2d`` lays out its devices.  The data group of a rank (the ranks
of its space index over the data groups) carries the loss normalisers and
the logged terms (``parallel/ddp.py``); BatchNorm moments and the gradient
sum go over the whole world.

Slabs (:class:`Slab`): a tensor on the space path is a rank's rows
``[lo, hi)`` of a global ``(B, X, Y, Z, C)`` tensor; every rank knows every
rank's bounds, which follow from the global sizes alone
(:func:`even_bounds`, :func:`window_bounds`), so each rank works out every
exchange's plan by itself and no sizes are exchanged.  A slab may hold no
rows (a deep Swin stage with fewer window columns than ranks).

Exchanges (autograd-aware):

- :func:`reshard_x` -- rank r's output row i is global row ``rows[r][i]``
  of the source slabs (or ``fill`` for -1): the move to window-aligned
  slabs, the cyclic shift (a wrapped map), patch merging's even pairs,
  the nearest upsample (a source row a function of the destination row),
  and every conv's and pool's input rows (:func:`window_rows`).  Its
  backward adds each row's gradient back into the row it came from.
- :func:`halo_x` -- a slab with ``lo`` rows before it and ``hi`` after, zero
  (``fill``) beyond the global edges: a :func:`reshard_x`.
- :func:`gather_x` -- every rank's rows, the whole extent, on every rank of
  the space group (the head outputs before propose).  Its backward returns
  the rank's own rows of the gradient, not a sum: every rank of a space
  group computes the same loss from the gathered outputs.  With
  ``sum_grad`` the ranks compute different parts of the loss from it (the
  RCNN's RoI blocks, :func:`row_block`), and the backward sums the
  gradient over the space group before it takes the rank's rows (a
  reduce-scatter: one all-reduce, then the rank's rows).
- :func:`all_reduce_sum` -- a small tensor summed over the space group (the
  FCOS head's GroupNorm moments, ``models/layers.group_norm``); its
  backward is the same all-reduce of the gradient.

Collectives: an exchange whose rows all stay on their rank runs none (every
rank computes the same plan, so all agree).  Otherwise each rank packs the
rows it sends to every other rank into one buffer, padded to the largest
rank's, and the space group runs one ``all_gather`` of the buffers as
bytes, forward and backward alike.  That one collective serves NCCL (the
multi-card case) and gloo, which carries CUDA tensors for ``all_gather``
and ``all_reduce`` (the one-card check); gloo's point-to-point
``send``/``recv`` are not used.  The all-gather moves every rank's buffer
to every rank of the group: at two ranks a space group that is what a pair
of sends would move.
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from nerf_rpn_tpu_torch.parallel import ddp

# batch keys whose (B, X, Y, Z, C) grids split their x extent over the
# space group (``mesh.py`` GRID_KEYS); other per-scene arrays split over the
# data groups only
GRID_KEYS = frozenset({"grids"})


@dataclass(frozen=True)
class SpaceGroups:
    """A rank's place in an ``n_data x n_space`` layout and its groups
    (None where a group is the rank alone)."""

    n_data: int
    n_space: int
    data_index: int
    space_index: int
    space_group: object = None
    data_group: object = None


def make_groups(n_data: int, n_space: int) -> SpaceGroups:
    """The data and space groups of ``n_data x n_space`` ranks out of the
    world (every rank calls it, in the same order); also makes it the
    layout that ``parallel/ddp.py``'s data-group sums read."""
    world, rank = ddp.world(), ddp.rank()
    if n_data < 1 or n_space < 1 or n_data * n_space != world:
        raise ValueError(f"a {n_data} x {n_space} layout needs {n_data * n_space} ranks, "
                         f"the world has {world}")
    space_group = data_group = None
    for d in range(n_data):  # every rank makes every group, in one order
        g = dist.new_group(list(range(d * n_space, (d + 1) * n_space))) if n_space > 1 else None
        if d == rank // n_space:
            space_group = g
    for s in range(n_space):
        g = dist.new_group(list(range(s, world, n_space))) if n_data > 1 else None
        if s == rank % n_space:
            data_group = g
    groups = SpaceGroups(n_data, n_space, rank // n_space, rank % n_space, space_group,
                         data_group)
    ddp.set_layout(groups)
    return groups


def even_bounds(extent: int, n: int) -> tuple[tuple[int, int], ...]:
    """``n`` contiguous slabs of ``extent`` rows, the first ``extent % n``
    one row longer."""
    base, extra = divmod(extent, n)
    cuts = np.cumsum([0] + [base + (r < extra) for r in range(n)])
    return tuple((int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:]))


def window_bounds(extent: int, window: int, n: int):
    """Window-aligned slabs: the ``ceil(extent / window)`` window columns
    split as :func:`even_bounds` splits rows.  Returns ``(rows, columns)``,
    each a ``(lo, hi)`` a rank; a slab's rows stop at ``extent``."""
    cols = even_bounds(-(-extent // window), n)
    rows = tuple((min(a * window, extent), min(b * window, extent)) for a, b in cols)
    return rows, cols


@dataclass(frozen=True)
class Slab:
    """Every rank's rows ``[lo, hi)`` of a global x ``extent``, and, for a
    window-aligned slab, its window columns."""

    groups: SpaceGroups
    bounds: tuple[tuple[int, int], ...]
    extent: int
    cols: tuple[tuple[int, int], ...] | None = None

    @property
    def lo(self) -> int:
        return self.bounds[self.groups.space_index][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.groups.space_index][1]

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    @property
    def col_lo(self) -> int:
        return self.cols[self.groups.space_index][0]

    @property
    def col_hi(self) -> int:
        return self.cols[self.groups.space_index][1]

    def even(self, extent: int) -> "Slab":
        """Even slabs of another extent, in the same groups."""
        return Slab(self.groups, even_bounds(extent, self.groups.n_space), extent)

    def windows(self, extent: int, window: int) -> "Slab":
        """Window-aligned slabs of another extent, in the same groups."""
        rows, cols = window_bounds(extent, window, self.groups.n_space)
        return Slab(self.groups, rows, extent, cols)


def input_slab(groups: SpaceGroups, x_extent: int) -> Slab:
    """The slabs that :func:`shard_grid` gives a grid of ``x_extent`` rows."""
    return Slab(groups, even_bounds(x_extent, groups.n_space), x_extent)


# ---------------------------------------------------------------------------
# The input split
# ---------------------------------------------------------------------------


def _check_x(name: str, x_extent: int, n_space: int) -> None:
    if x_extent % n_space:
        raise ValueError(
            f"grid batch entry {name!r} has x extent {x_extent} not divisible by the "
            f"space axis ({n_space}); pad the grid (collate pad_multiple) to a multiple of it")


def _data_block(n: int, groups: SpaceGroups) -> slice:
    if n % groups.n_data:
        raise ValueError(f"a batch of {n} scenes does not split over {groups.n_data} "
                         "data groups")
    k = n // groups.n_data
    return slice(groups.data_index * k, (groups.data_index + 1) * k)


def shard_grid(grids: torch.Tensor, groups: SpaceGroups, name: str = "grids") -> torch.Tensor:
    """This rank's part of a global ``(B, X, Y, Z, C)`` grid batch: its
    data group's scenes, its even slab of their x extent."""
    _check_x(name, grids.shape[1], groups.n_space)
    lo, hi = even_bounds(grids.shape[1], groups.n_space)[groups.space_index]
    return grids[_data_block(grids.shape[0], groups), lo:hi]


def shard_batch(batch: dict, groups: SpaceGroups) -> dict:
    """A global batch dict -> this rank's: ``GRID_KEYS`` grids split over
    the data groups and along x over the space group (X must divide by
    ``n_space``), other per-scene tensors (gt boxes, sizes) over the data
    groups only, and so each tensor of a list or tuple (the RCNN's
    per-level ``features``, whole on every rank of a space group); other
    entries are dropped, as ``mesh.shard_batch`` drops them."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            if k in GRID_KEYS and v.dim() == 5:
                out[k] = shard_grid(v, groups, k)
            else:
                out[k] = v[_data_block(v.shape[0], groups)]
        elif isinstance(v, (list, tuple)) and v and all(isinstance(t, torch.Tensor) for t in v):
            out[k] = type(v)(t[_data_block(t.shape[0], groups)] for t in v)
    return out


def row_block(n: int, groups: SpaceGroups) -> slice:
    """This rank's contiguous block of ``n`` rows that every rank of its
    space group holds alike (the RCNN's sampled RoIs of a scene), split as
    :func:`even_bounds` splits an extent: the ranks of a space group then
    compute disjoint parts of a loss."""
    lo, hi = even_bounds(n, groups.n_space)[groups.space_index]
    return slice(lo, hi)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Plan:
    """One rank's share of an exchange.  ``index``: each output row's row
    in ``cat([x, fill row, received rows])``; ``local``: (start, stop) where
    the output is a plain run of x's rows, else None.  ``send``: x's rows
    this rank sends, all destinations in rank order; ``send_counts`` /
    ``recv_counts``: rows to / from each rank; ``width``: the largest
    buffer of any rank (0: no collective); ``back_width``: the same for the
    backward's buffers.  :meth:`on` keeps each index tensor's copy on a
    device (a copy from the host a call would cost a transfer each)."""

    index: torch.Tensor
    local: tuple[int, int] | None
    send: torch.Tensor
    send_counts: tuple[int, ...]
    recv_counts: tuple[int, ...]
    width: int
    back_width: int
    copies: dict = field(default_factory=dict, compare=False)

    def on(self, name: str, device: torch.device) -> torch.Tensor:
        key = (name, device)
        if key not in self.copies:
            with torch.inference_mode(False):  # cached: a later train step saves them
                self.copies[key] = getattr(self, name).to(device)
        return self.copies[key]


@functools.lru_cache(maxsize=4096)
def _plan(have: tuple[tuple[int, int], ...], rows: tuple[tuple[int, ...], ...],
          me: int) -> _Plan:
    n = len(have)
    owner = {}
    for r, (lo, hi) in enumerate(have):
        for g in range(lo, hi):
            owner[g] = r
    # traffic[src][dst]: the source rows (global) src sends dst, in dst's order
    traffic = [[[] for _ in range(n)] for _ in range(n)]
    for d, want in enumerate(rows):
        for g in want:
            if g >= 0 and owner[g] != d:
                traffic[owner[g]][d].append(g)
    width = max(sum(len(traffic[s][d]) for d in range(n)) for s in range(n))
    back_width = max(sum(len(traffic[s][d]) for s in range(n)) for d in range(n))
    lo, hi = have[me]
    n_local = hi - lo
    recv_at = {}  # (src, global row) -> rows of the received block, in order
    pos = n_local + 1
    for s in range(n):
        for g in traffic[s][me]:
            recv_at.setdefault((s, g), []).append(pos)
            pos += 1
    index = []
    for g in rows[me]:
        if g < 0:
            index.append(n_local)
        elif owner[g] == me:
            index.append(g - lo)
        else:
            index.append(recv_at[(owner[g], g)].pop(0))
    local = None
    if index and all(i == index[0] + k for k, i in enumerate(index)) and \
            index[-1] < n_local:
        local = (index[0], index[-1] + 1)
    elif not index:
        local = (0, 0)
    send = [g - lo for d in range(n) for g in traffic[me][d]]
    with torch.inference_mode(False):  # cached: a later train step saves them
        index_t = torch.tensor(index, dtype=torch.long)
        send_t = torch.tensor(send, dtype=torch.long)
    return _Plan(index_t, local, send_t, tuple(len(traffic[me][d]) for d in range(n)),
                 tuple(len(traffic[s][me]) for s in range(n)), width, back_width)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


# None, or the list that :func:`trace_exchanges` fills
_TRACE = None


@contextlib.contextmanager
def trace_exchanges():
    """Yields a list of ``(kind, bytes, ms)``, one a collective of the
    exchanges run inside: the all-gathered bytes that reach this rank and
    the host ms of the collective with the device synchronised before and
    after it (a traced run is slower; for readings only)."""
    global _TRACE
    _TRACE = log = []
    try:
        yield log
    finally:
        _TRACE = None


def _all_gather_rows(buf: torch.Tensor, width: int, group, kind: str) -> list[torch.Tensor]:
    """``buf`` (m, ...) padded to ``width`` rows, all-gathered over
    ``group`` as bytes: every rank's (width, ...) buffer."""
    shape, dtype = buf.shape[1:], buf.dtype
    if buf.shape[0] < width:
        buf = torch.cat([buf, buf.new_zeros((width - buf.shape[0], *shape))])
    raw = buf.contiguous().view(-1).view(torch.uint8)
    out = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    if _TRACE is None:
        dist.all_gather(out, raw, group=group)
    else:
        sync = torch.cuda.synchronize if raw.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        dist.all_gather(out, raw, group=group)
        sync()
        _TRACE.append((kind, raw.numel() * len(out), (time.perf_counter() - t0) * 1e3))
    return [o.view(dtype).view(width, *shape) for o in out]


class _Exchange(torch.autograd.Function):
    """The rows of x that other ranks own and this rank's output reads:
    ``(B, n_recv, ...)``, in the order of the plan's received block.  The
    backward sends each received row's gradient back and adds the rows that
    come back into x's gradient."""

    @staticmethod
    def forward(ctx, x, have, rows, group):
        ctx.have, ctx.rows, ctx.group, ctx.x_shape = have, rows, group, x.shape
        me = dist.get_rank(group)
        plan = _plan(have, rows, me)
        send = x.index_select(1, plan.on("send", x.device)).movedim(1, 0)
        bufs = _all_gather_rows(send, plan.width, group, "reshard")
        parts = []
        for s, buf in enumerate(bufs):
            if s != me and plan.recv_counts[s]:
                # rank s's buffer: its rows for each destination, in rank order
                off = sum(_plan(have, rows, s).send_counts[:me])
                parts.append(buf[off:off + plan.recv_counts[s]])
        recv = torch.cat(parts) if parts else x.new_zeros((0, x.shape[0], *x.shape[2:]))
        return recv.movedim(0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        have, rows, group = ctx.have, ctx.rows, ctx.group
        me = dist.get_rank(group)
        plan = _plan(have, rows, me)
        back = _all_gather_rows(grad.movedim(1, 0), plan.back_width, group, "reshard backward")
        gx = grad.new_zeros(ctx.x_shape)
        start = 0
        for d, count in enumerate(plan.send_counts):
            if d != me and count:
                # rank d's buffer: the gradients of the rows it received,
                # sources in rank order
                off = sum(_plan(have, rows, d).recv_counts[:me])
                idx = plan.on("send", grad.device)[start:start + count]
                gx.index_add_(1, idx, back[d][off:off + count].movedim(0, 1))
            start += count
        return gx, None, None, None


def reshard_x(x: torch.Tensor, src: Slab, rows: Sequence[Sequence[int]],
              fill: float = 0.0) -> torch.Tensor:
    """Rank r's output ``(B, len(rows[r]), ...)``: row i is global row
    ``rows[r][i]`` of ``x``'s slabs ``src`` (-1: ``fill``).  Every rank of
    the space group must call it with the same ``rows``."""
    have = tuple(src.bounds)
    rows = tuple(tuple(int(g) for g in r) for r in rows)
    plan = _plan(have, rows, src.groups.space_index)
    if plan.width == 0 and plan.local is not None:
        return x[:, plan.local[0]:plan.local[1]]
    parts = [x, x.new_full((x.shape[0], 1, *x.shape[2:]), fill)]
    if plan.width:
        parts.append(_Exchange.apply(x, have, rows, src.groups.space_group))
    return torch.cat(parts, 1).index_select(1, plan.on("index", x.device))


def window_rows(src: Slab, dst: Slab, kernel: int, stride: int, padding: int
                ) -> tuple[tuple[int, ...], ...]:
    """The input rows (-1 beyond the edges) of each rank's output rows
    ``dst`` of a window op (a conv or a pool) of ``kernel``, ``stride`` and
    ``padding`` along x over input slabs ``src``."""
    out = []
    for lo, hi in dst.bounds:
        if hi <= lo:
            out.append(())
            continue
        first = lo * stride - padding
        want = range(first, (hi - 1) * stride - padding + kernel)
        out.append(tuple(g if 0 <= g < src.extent else -1 for g in want))
    return tuple(out)


def halo_x(x: torch.Tensor, slab: Slab, lo: int, hi: int, fill: float = 0.0) -> torch.Tensor:
    """The slab with ``lo`` rows before it and ``hi`` after, from the
    neighbours, ``fill`` beyond the global edges; an empty slab stays
    empty."""
    rows = tuple(() if b <= a else
                 tuple(g if 0 <= g < slab.extent else -1 for g in range(a - lo, b + hi))
                 for a, b in slab.bounds)
    return reshard_x(x, slab, rows, fill)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab: Slab, sum_grad: bool):
        ctx.lo, ctx.hi, ctx.sum_grad = slab.lo, slab.hi, sum_grad
        ctx.group = slab.groups.space_group
        width = max(b - a for a, b in slab.bounds)
        bufs = _all_gather_rows(x.movedim(1, 0), width, slab.groups.space_group, "gather")
        parts = [buf[:b - a] for buf, (a, b) in zip(bufs, slab.bounds)]
        return torch.cat(parts).movedim(0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grad:
            grad = _all_reduce(grad, ctx.group, "gather backward")
        return grad[:, ctx.lo:ctx.hi], None, None


def gather_x(x: torch.Tensor, slab: Slab, sum_grad: bool = False) -> torch.Tensor:
    """The whole extent ``(B, slab.extent, ...)`` on every rank of the space
    group.  The gradient of a rank's slab is its own rows of the output's
    gradient where every rank computes the same loss from the gathered
    tensor; with ``sum_grad``, where each rank computes its own part of the
    loss, its own rows of the output's gradient summed over the space
    group."""
    if slab.groups.n_space == 1:
        return x
    return _Gather.apply(x, slab, sum_grad)


def _all_reduce(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    if _TRACE is None:
        dist.all_reduce(out, group=group)
    else:
        sync = torch.cuda.synchronize if out.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        dist.all_reduce(out, group=group)
        sync()
        _TRACE.append((kind, out.numel() * out.element_size(),
                       (time.perf_counter() - t0) * 1e3))
    return out


class _AllReduce(torch.autograd.Function):
    """``all_reduce(SUM)`` over a space group: every rank reads the sum, so
    a rank's input gradient is the sum over the ranks of the output
    gradients -- the backward is the same all-reduce (``ddp.AllReduceSum``
    over a group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, "all_reduce")

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, "all_reduce backward"), None


def all_reduce_sum(x: torch.Tensor, groups: SpaceGroups) -> torch.Tensor:
    """``x`` summed over the rank's space group, with autograd; no
    collective in a space group of one.  Every rank of the group calls
    it."""
    if groups.n_space == 1:
        return x
    return _AllReduce.apply(x, groups.space_group)


def nearest_rows(in_extent: int, out_extent: int) -> tuple[int, ...]:
    """The source row of each output row of a ``nearest-exact`` resize
    along x, as ``F.interpolate`` picks it."""
    idx = torch.arange(in_extent, dtype=torch.float64).view(1, 1, in_extent)
    return tuple(int(v) for v in
                 F.interpolate(idx, size=out_extent, mode="nearest-exact").view(-1))


def keep_graph_empty(shape: Sequence[int], like: torch.Tensor,
                     *linked: torch.Tensor) -> torch.Tensor:
    """An empty output of ``shape`` for an op whose slab holds no rows
    (a convolution or pool cannot run on 0 rows), tied into the autograd
    graph through ``like`` and ``linked`` with a zero gradient: each of them
    then takes part in the backward (its exchanges' collectives) and every
    parameter among them gets a gradient, as on the ranks that hold rows."""
    out = like.new_zeros(shape)
    if torch.is_grad_enabled():
        for t in (like, *linked):
            if t is not None and t.requires_grad:
                out = out + t.sum() * 0
    return out
