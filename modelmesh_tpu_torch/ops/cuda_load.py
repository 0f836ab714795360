"""The auction's implied load: the fixed-order kernel and its plain versions.

Port of ``modelmesh_tpu/ops/auction.py::_implied_load_fused`` (the
reference's ``load_impl="fused"``):

    load[m] = sum_{n, k} sizes[n] * valid[n, k] * [idx[n, k] == m]

The plain version (``implied_load_ref``) is the reference's chunked one-hot
compare-reduce, line for line. The kernel (``csrc/implied_load.cu``, built
at first use by ``_build``) is one launch: a block takes ``ROWS`` rows,
each of its warps adds its entries to a histogram of its own one by one
in entry order, the warps' histograms are summed in
warp order into the block's partial, and the block partials in groups of
``GROUP`` and the groups in order, by the blocks that finish last. No
float atomics, so unlike ``index_add_`` on the card it gives the same
load on every run. ``implied_load_tree`` is that summation order in
PyTorch: the kernel's bits at any sizes, and its grid and tree are plain
functions of (N, S, M) (``grid``, ``combine_groups``).

``implied_load`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. ``launches`` counts kernel
launches. A launch reuses a workspace (the block partials, the group sums
and the tickets, which every launch leaves zero) kept per device and
stream.

``implied_load`` takes ``col_psum``: the sum over the row blocks of a
sharded problem (``parallel.mesh.AxisSum`` over the model axis). On the
card each block's launch stops at its block partials, the shards' partials
are gathered in rank order and the combine runs once over all of them, in
the launch's own two-level order, so row blocks of a multiple of
``ROWS`` rows give the load of the whole assignment bit for bit; the combine is part of the launch and is not counted again.
On the CPU the shards' loads are added (an ordinary sum).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from modelmesh_tpu_torch.ops import _build

LIB = "implied_load"
# Flat (idx, weight) entries per step of the plain version's compare-reduce
# (the reference's _FUSED_CHUNK).
FUSED_CHUNK = 8192

# The kernel's layout (the constants of csrc/implied_load.cu): THREADS
# threads a block, ROWS rows a block partial, GROUP block partials a
# first-level sum.
THREADS = 512
WARPS = THREADS // 32
ROWS = 1024
GROUP = 16

# Kernel launches since the process started (or the caller last zeroed them
# with reset_launches()).
launches = {"implied_load": 0}

# (device index, stream handle) -> (f32 partials and group sums, int32
# tickets); grown, never shrunk.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class Grid:
    """One launch's shape, from (N, S, M) alone."""

    parts: int    # blocks, one f32[M] partial each
    groups: int   # first-level sums of GROUP partials
    ld: int       # the workspace's row stride: M rounded up to 4

    def workspace(self) -> tuple[int, int]:
        """(f32 elements, int32 tickets) of the unsharded route."""
        return (self.parts + self.groups) * self.ld, self.groups + 1


@functools.lru_cache(maxsize=256)
def grid(n: int, s: int, m: int) -> Grid:
    """The launch for idx [n, s] onto m instances: a block partial per
    ROWS rows."""
    if n <= 0 or s <= 0 or m <= 0:
        raise ValueError(f"empty implied load: n={n}, s={s}, m={m}")
    parts = -(-n // ROWS)
    return Grid(parts=parts, groups=-(-parts // GROUP), ld=-(-m // 4) * 4)


def combine_groups(parts: int) -> list[range]:
    """The block partials each first-level sum takes, in index order; the
    group sums are then added in this list's order (one group: its sum is
    the load)."""
    return [range(g, min(g + GROUP, parts)) for g in range(0, parts, GROUP)]


def implied_load_ref(idx, valid, sizes, num_instances: int) -> torch.Tensor:
    """Plain version: the reference's scatter-free histogram, a one-hot
    compare-reduce over chunks of FUSED_CHUNK flat entries; padded entries
    point one past the instance range and match nothing."""
    dev = sizes.device
    if idx.numel() == 0:  # zero-model problem: nothing contributes
        return torch.zeros(num_instances, dtype=torch.float32, device=dev)
    contrib = sizes[:, None] * valid.to(torch.float32)  # [N, K]
    flat_idx = idx.reshape(-1).to(torch.int32)
    flat_w = contrib.reshape(-1)
    s = flat_idx.shape[0]
    chunk = min(FUSED_CHUNK, s)
    pad = (-s) % chunk
    if pad:
        flat_idx = torch.nn.functional.pad(flat_idx, (0, pad),
                                           value=num_instances)
        flat_w = torch.nn.functional.pad(flat_w, (0, pad))
    cols = torch.arange(num_instances, dtype=torch.int32, device=dev)
    acc = torch.zeros(num_instances, dtype=torch.float32, device=dev)
    for ic, wc in zip(flat_idx.view(-1, chunk), flat_w.view(-1, chunk)):
        acc = acc + torch.where(
            ic[:, None] == cols[None, :], wc[:, None], 0.0
        ).sum(dim=0)
    return acc


def _seq_sum(rows) -> torch.Tensor:
    """rows[0] + rows[1] + ..., from 0.0 in order (the kernel's sums)."""
    acc = torch.zeros_like(rows[0])
    for r in rows:
        acc = acc + r
    return acc


def block_partials_tree(idx, valid, sizes, num_instances: int) -> torch.Tensor:
    """f32[parts, M]: the kernel's block partials in its order. Block b
    takes rows [b * ROWS, (b + 1) * ROWS); its entries in row-major order,
    32 a step, go to warp ``step % WARPS``, lane ``entry % 32``; each warp
    adds its entries to its histogram one by one in (step, lane) order,
    and the block's partial is its warps' histograms added in warp
    order."""
    n, s = idx.shape
    m = num_instances
    g = grid(n, s, m)
    dev = sizes.device
    pad = g.parts * ROWS - n
    ids = torch.nn.functional.pad(idx, (0, 0, 0, pad), value=-1)
    w = torch.nn.functional.pad(sizes[:, None] * valid.to(torch.float32),
                                (0, 0, 0, pad))
    # The bin of each entry, m (a dump column) where it matches none.
    col = torch.where((ids >= 0) & (ids < m), ids, m)
    shape = (g.parts, ROWS * s // THREADS, WARPS, 32)
    col, w = col.reshape(shape), w.reshape(shape)
    rows = torch.arange(g.parts * WARPS, device=dev)
    hist = torch.zeros((g.parts * WARPS, m + 1), dtype=torch.float32,
                       device=dev)
    for u in range(shape[1]):
        cu, wu = col[:, u].reshape(-1, 32), w[:, u].reshape(-1, 32)
        for lane in range(32):
            c = cu[:, lane]
            hist[rows, c] = hist[rows, c] + wu[:, lane]
    hist = hist[:, :m].reshape(g.parts, WARPS, m)
    return _seq_sum(list(hist.unbind(1)))


def combine_tree(partial: torch.Tensor) -> torch.Tensor:
    """f32[M]: block partials f32[parts, M] summed in the kernel's
    two-level order (``combine_groups``)."""
    sums = [_seq_sum(list(partial[grp.start:grp.stop].unbind(0)))
            for grp in combine_groups(partial.shape[0])]
    return sums[0] if len(sums) == 1 else _seq_sum(sums)


def implied_load_tree(idx, valid, sizes, num_instances: int) -> torch.Tensor:
    """Plain version in the kernel's summation order: its bits at any
    sizes (``block_partials_tree`` then ``combine_tree``)."""
    n, s = idx.shape
    if n * s == 0 or num_instances == 0:
        return torch.zeros(num_instances, dtype=torch.float32,
                           device=sizes.device)
    return combine_tree(block_partials_tree(idx, valid, sizes,
                                            num_instances))


def _check(idx, valid, sizes) -> tuple[int, int]:
    """idx i64[N, S] and valid bool[N, S] on sizes' device, sizes f32[N].
    Returns (N, S)."""
    if idx.dim() != 2 or idx.dtype != torch.int64:
        raise TypeError(f"idx must be 2-D int64 (got {idx.dtype}, "
                        f"{idx.dim()}-D)")
    n, s = idx.shape
    if valid.dtype != torch.bool or valid.shape != idx.shape:
        raise TypeError(f"valid must be bool{list(idx.shape)} (got "
                        f"{valid.dtype}{list(valid.shape)})")
    if sizes.dtype != torch.float32 or sizes.shape != (n,):
        raise TypeError(f"sizes must be float32[{n}] (got {sizes.dtype}"
                        f"{list(sizes.shape)})")
    for name, t in (("idx", idx), ("valid", valid)):
        if t.device != sizes.device:
            raise ValueError(f"{name} is on {t.device}, sizes on "
                             f"{sizes.device}")
    return n, s


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit column stride: a view of rows (the sparse auction's
    ``idx[:, :nsel]``) is taken as it is, by its row stride; any other
    layout is copied."""
    return t if t.shape[1] <= 1 or t.stride(1) == 1 else t.contiguous()


def row_stride(t: torch.Tensor) -> int:
    """The row stride the kernel reads ``t`` (unit column stride) by: a
    single row's stride is free in PyTorch, so it is taken as S."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _workspace(device, g: Grid):
    """The unsharded route's workspace on ``device``'s current stream:
    (f32 partials then group sums, int32 tickets, zero between launches).
    Kept per stream, so launches that share one run in stream order."""
    index = device.index
    key = (index, _build.current_stream(index))
    floats, tickets = g.workspace()
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tickets:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = _workspaces[key] = (
            torch.empty(max(floats, old[0]), dtype=torch.float32,
                        device=device),
            torch.zeros(max(tickets, old[1]), dtype=torch.int32,
                        device=device),
        )
    return ws


def _combine(partial: torch.Tensor) -> torch.Tensor:
    """The launch's two-level sum of block partials f32[parts, M] ->
    f32[M], over the partials of several row blocks."""
    parts, m = partial.shape
    out = torch.empty(m, dtype=torch.float32, device=partial.device)
    _build.launch(LIB, "mm_load_combine", partial.device,
                  partial.contiguous().data_ptr(), out.data_ptr(), parts, m)
    return out


def implied_load(idx, valid, sizes, num_instances: int,
                 col_psum=None) -> torch.Tensor:
    """f32[num_instances]: the memory load the assignment implies per
    instance, summed in a fixed order (``col_psum``: over the row blocks of
    a sharded problem, module docstring)."""
    n, s = _check(idx, valid, sizes)
    dev = sizes.device
    if dev.type == "cpu":
        load = implied_load_ref(idx, valid, sizes, num_instances)
        return load if col_psum is None else col_psum(load)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dev}")
    m = num_instances
    if n * s == 0 or m == 0:
        return torch.zeros(m, dtype=torch.float32, device=dev)
    idx, valid = _rows(idx), _rows(valid)
    sizes = sizes.contiguous()
    g = grid(n, s, m)
    if col_psum is None:
        floats, tickets = _workspace(dev, g)
        partial = floats.data_ptr()
        out = torch.empty(m, dtype=torch.float32, device=dev)
        ptrs = (partial, partial + 4 * g.parts * g.ld, out.data_ptr(),
                tickets.data_ptr())
        ld = g.ld
    else:
        part = torch.empty((g.parts, m), dtype=torch.float32, device=dev)
        ptrs = (part.data_ptr(), None, None, None)
        ld = m
    _build.launch(
        LIB, "mm_implied_load", dev,
        idx.data_ptr(), valid.data_ptr(), sizes.data_ptr(), *ptrs,
        n, s, row_stride(idx), row_stride(valid), m, ld,
    )
    _build.count_launch(launches, "implied_load")
    return out if col_psum is None else col_psum.combine(_combine, part)
