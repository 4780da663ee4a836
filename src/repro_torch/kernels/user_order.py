"""A spatial order of the users for the dense ray-cast kernel.

The kernel (``csrc/raycast.cu``) gives each thread block one tile of
:data:`TILE_USERS` users that lie close together, classifies every
triangle once against the tile's bounding box, and tests single users
only against the triangles whose edges cross that box.  This module
builds what it reads: the users sorted by a Morton (Z-order) code of
their coordinates, the bounding box of each tile, and the index that
gathers the kernel's counts back to the callers' order.

The order decides only how much work the kernel skips, never a count, so
any order is correct; the Morton code is quantized on the users' own
bounding box.  Everything runs as plain torch ops on the users' device,
once per user set (the engine keeps the result in its snapshot's kernel
memo), with no transfer to the host, so that on the card the build is a
short queue of launches that the host does not wait for.  The rank-count
kernel (``csrc/rank_count.cu``) reads the same order and computes the
boxes of its smaller sub-tiles itself.  The grid kernel's bucketing
(:mod:`repro_torch.kernels.grid_raycast`) orders the
users inside each grid cell with the same code and boxes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "TILE_USERS", "UserOrder", "build_user_order", "check_order", "morton_codes", "tile_boxes",
]

#: Users per tile: the kernel's 128 threads times 8 users a thread.
TILE_USERS = 1024

#: Bits per coordinate: a 30-bit code, a non-negative int32, which sorts in
#: half the radix passes of an int64.
_MORTON_BITS = 15


class UserOrder(NamedTuple):
    """One user set in Morton order, cut into tiles of :data:`TILE_USERS`
    users (the last one ragged)."""

    xs_s: torch.Tensor  # [N] f32, sorted
    ys_s: torch.Tensor  # [N] f32, sorted
    perm: torch.Tensor  # [N] int32: sorted position -> the user's index
    unsort: torch.Tensor  # [N] int32: the user's index -> sorted position
    boxes: torch.Tensor  # [n_tiles, 4] f32: (x_min, y_min, x_max, y_max) of each tile


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Bits 0..14 of ``v`` (int32) moved to the even bit positions."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def morton_codes(xy: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``[N]`` int32 Morton codes of the points ``xy`` (``[2, N]`` f32),
    each coordinate quantized to 15 bits on ``[lo, hi]`` (``[2, 1]``);
    points outside clamp to the edge, NaNs to 0."""
    top = (1 << _MORTON_BITS) - 1
    cells = torch.nan_to_num((xy - lo) * (top / (hi - lo).clamp_min(1e-30)), nan=0.0)
    spread = _spread_bits(cells.clamp_(0, top).to(torch.int32))
    return spread[0] | (spread[1] << 1)


def tile_boxes(xy_s: torch.Tensor, tile: int) -> torch.Tensor:
    """``[n_tiles, 4]`` f32 boxes ``(x_lo, y_lo, x_hi, y_hi)`` of the
    points ``xy_s`` (``[2, N]``, ``N >= 1``) cut into runs of ``tile``, the
    last one ragged: it repeats its last point, so its box does not change."""
    n = xy_s.shape[1]
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    tiled = torch.cat([xy_s, xy_s[:, -1:].expand(2, pad)], dim=1).reshape(2, n_tiles, tile)
    t_lo, t_hi = torch.aminmax(tiled.transpose(0, 1), dim=2)  # [n_tiles, 2] each
    return torch.cat([t_lo, t_hi], dim=1)


def build_user_order(xs: torch.Tensor, ys: torch.Tensor) -> UserOrder:
    """The :class:`UserOrder` of users ``xs, ys`` (``[N]`` f32), on their
    device."""
    if xs.ndim != 1 or ys.shape != xs.shape:
        raise ValueError(f"xs, ys must both be [N], got {tuple(xs.shape)}, {tuple(ys.shape)}")
    n, dev = xs.shape[0], xs.device
    if n == 0:
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        return UserOrder(xs.clone(), ys.clone(), none, none,
                         torch.zeros((0, 4), dtype=torch.float32, device=dev))
    xy = torch.stack([xs, ys])  # [2, N]
    lo, hi = torch.aminmax(xy, dim=1, keepdim=True)
    perm = torch.sort(morton_codes(xy, lo, hi), stable=True).indices
    xy_s = xy.index_select(1, perm)
    unsort = torch.empty(n, dtype=torch.int32, device=dev).scatter_(
        0, perm, torch.arange(n, dtype=torch.int32, device=dev))
    return UserOrder(xy_s[0], xy_s[1], perm.to(torch.int32), unsort, tile_boxes(xy_s, TILE_USERS))


def check_order(order: UserOrder, n: int, dev: torch.device) -> None:
    """Raise ``ValueError`` unless ``order`` has the shapes, types and
    device of an order of ``n`` users on ``dev`` (what a kernel reads)."""
    n_tiles = -(-n // TILE_USERS)
    for name, t, shape, dtype in (
        ("xs_s", order.xs_s, (n,), torch.float32),
        ("ys_s", order.ys_s, (n,), torch.float32),
        ("perm", order.perm, (n,), torch.int32),
        ("unsort", order.unsort, (n,), torch.int32),
        ("boxes", order.boxes, (n_tiles, 4), torch.float32),
    ):
        if t.device != dev or t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"order.{name} must be contiguous {dtype} {shape} on {dev}")
