"""Device-resident training data: padded dual-sorted COO + dense tiles.

The reference walks per-user adjacency lists (hgaprec.cc:928-941). The
device layout is static-shape COO, padded to a block multiple, kept in
two sort orders so both the user-side and item-side segment reductions see
sorted segment ids:

  * user order: (u, i) lexsorted — user-side segment_sum is sorted.
  * item order: permutation `item_order` of the user-ordered arrays such
    that i_ids[item_order] is ascending — item-side segment_sum is sorted.

Padding entries carry y = 0 (they contribute nothing to any shape update)
and point at the last row of each factor table so gathers stay in bounds
and sorted order is preserved.

For the dense path, `dense_y` materializes the count matrix once
(uint8, like the reference's yval_t, env.hh:20) when affordable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hgaprec_jax.data.ratings import RatingsStore
from hgaprec_jax.ops.mxu_tail import TailCompact, build_tail_compact


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceData:
    # user-sorted COO, padded to P
    u_ids: jax.Array        # i32[P]
    i_ids: jax.Array        # i32[P]
    y: jax.Array            # f32[P] (0 on padding)
    # permutation into item-sorted order and the sorted item ids
    item_order: jax.Array   # i32[P]
    i_ids_sorted: jax.Array  # i32[P]
    u_ids_by_item: jax.Array  # i32[P] = u_ids[item_order]
    # optional dense count matrix for the dense path; uint8 like the
    # reference's yval_t (env.hh:20) so Netflix-scale Y fits on device —
    # converted to f32 tile-by-tile inside the sweep
    dense_y: Optional[jax.Array]  # u8[N, M] or None
    # hybrid head/tail split for power-law catalogs too wide to densify
    # (ops/sweep.py::sweep_hybrid): head = top-degree items as a dense
    # uint8 block whose column j is item head_items[j]; tail = the
    # remaining nonzeros as user-sorted COO
    head_items: Optional[jax.Array] = None     # i32[T]
    head_dense_y: Optional[jax.Array] = None   # u8[>=N, T]
    u_ids_tail: Optional[jax.Array] = None     # i32[PT]
    i_ids_tail: Optional[jax.Array] = None     # i32[PT]
    y_tail: Optional[jax.Array] = None         # f32[PT]
    # compact-id tail stream for the scatter-free sweep (ops/mxu_tail.py);
    # preferred over the raw tail COO when present
    tail_compact: Optional[TailCompact] = None

    @property
    def nnz_padded(self) -> int:
        return self.u_ids.shape[0]


def build_device_data(store: RatingsStore, *, pad_multiple: int = 1024,
                      dense: bool = True, dense_col_multiple: int = 4096,
                      dense_row_multiple: int = 512,
                      dense_limit_bytes: int = 10 << 30,
                      hybrid_head_items: int = 0,
                      head_limit_bytes: int = 4 << 30) -> DeviceData:
    """Build the static-shape device arrays from a finalized host store.

    hybrid_head_items > 0 (or "auto" sizing by the caller) additionally
    splits the nonzeros into a dense uint8 block over the top-T items by
    degree plus a tail COO stream (sweep_hybrid)."""
    u = store.coo_u.astype(np.int32)
    i = store.coo_i.astype(np.int32)
    y = store.coo_y.astype(np.float32)
    n, m = store.n, store.m
    nnz = u.size
    p = max(pad_multiple, -(-max(nnz, 1) // pad_multiple) * pad_multiple)
    pad = p - nnz

    head_items = head_dense = u_tail = i_tail = y_tail = None
    tail_compact = None
    t = 0
    if hybrid_head_items > 0 and m > 0 and nnz > 0:
        t = min(hybrid_head_items, m)
        npad = -(-max(n, 1) // dense_row_multiple) * dense_row_multiple
        # byte budget clips the head width; if the budget can't even fit
        # a 512-column block (huge N), fall back to pure segment rather
        # than silently exceeding head_limit_bytes
        budget = head_limit_bytes // max(npad, 1)
        if budget < min(t, 512):
            t = 0
        else:
            t = min(t, budget)
            if t >= 512:
                t = (t // 512) * 512
    if t > 0:
        deg = np.bincount(store.coo_i, minlength=m)
        head_ids = np.sort(np.argsort(-deg, kind="stable")[:t])
        head_ids = head_ids.astype(np.int32)
        col_of = np.full(m, -1, np.int32)
        col_of[head_ids] = np.arange(head_ids.size, dtype=np.int32)
        in_head = col_of[store.coo_i] >= 0
        hd = np.zeros((npad, head_ids.size), np.uint8)
        hd[store.coo_u[in_head], col_of[store.coo_i[in_head]]] = \
            np.minimum(store.coo_y[in_head], 255)
        ut = store.coo_u[~in_head].astype(np.int32)
        it = store.coo_i[~in_head].astype(np.int32)
        yt = store.coo_y[~in_head].astype(np.float32)
        pt = max(pad_multiple,
                 -(-max(ut.size, 1) // pad_multiple) * pad_multiple)
        padt = pt - ut.size
        u_tail = jnp.asarray(np.concatenate(
            [ut, np.full(padt, max(n - 1, 0), np.int32)]))
        i_tail = jnp.asarray(np.concatenate(
            [it, np.full(padt, max(m - 1, 0), np.int32)]))
        y_tail = jnp.asarray(np.concatenate(
            [yt, np.zeros(padt, np.float32)]))
        head_items = jnp.asarray(head_ids)
        head_dense = jnp.asarray(hd)
        tail_compact = build_tail_compact(ut, it, yt)

    # pad with max ids so both sort orders remain ascending
    u = np.concatenate([u, np.full(pad, max(n - 1, 0), np.int32)])
    i = np.concatenate([i, np.full(pad, max(m - 1, 0), np.int32)])
    y = np.concatenate([y, np.zeros(pad, np.float32)])
    item_order = np.lexsort((u, i)).astype(np.int32)

    dense_y = None
    if dense and n * m <= dense_limit_bytes and n > 0 and m > 0:
        # rows AND columns padded at build time so the sweep tiles the
        # huge uint8 matrix in place: an in-jit pad of Y would copy the
        # multi-GB array every step, and an odd N (Netflix: 480,189)
        # would otherwise degenerate the XLA path's user tiling. Rows are
        # padded whenever N could exceed a user tile (the landmine is
        # N > user_block with a small power-of-2 divisor, any byte size).
        big = n * m > (1 << 28)
        mp = -(-m // dense_col_multiple) * dense_col_multiple if big else m
        npad = (-(-n // dense_row_multiple) * dense_row_multiple
                if (big or n > 4096) else n)
        dy = np.zeros((npad, mp), np.uint8)
        dy[store.coo_u, store.coo_i] = np.minimum(store.coo_y, 255)
        dense_y = jnp.asarray(dy)

    return DeviceData(
        u_ids=jnp.asarray(u),
        i_ids=jnp.asarray(i),
        y=jnp.asarray(y),
        item_order=jnp.asarray(item_order),
        i_ids_sorted=jnp.asarray(i[item_order]),
        u_ids_by_item=jnp.asarray(u[item_order]),
        dense_y=dense_y,
        head_items=head_items,
        head_dense_y=head_dense,
        u_ids_tail=u_tail,
        i_ids_tail=i_tail,
        y_tail=y_tail,
        tail_compact=tail_compact,
    )


def dense_only_data(dense_y: jax.Array) -> DeviceData:
    """DeviceData around a u8 count matrix already on the device (e.g.
    data/synthetic.py::dense_counts_on_device), for the dense sweep
    alone: the COO leaves are placeholders, so neither the ELBO nor the
    other sweep modes can run on it."""
    z = jnp.zeros(8, jnp.int32)
    return DeviceData(u_ids=z, i_ids=z, y=jnp.zeros(8, jnp.float32),
                      item_order=z, i_ids_sorted=z, u_ids_by_item=z,
                      dense_y=dense_y)


def build_count_map_arrays(cmap, dtype=np.float32):
    """CountMap -> (u, i, y) arrays for device-side likelihood eval."""
    if not cmap:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, dtype))
    pairs = np.asarray(sorted(cmap.keys()), dtype=np.int32)
    vals = np.asarray([cmap[(int(a), int(b))] for a, b in pairs], dtype=dtype)
    return pairs[:, 0], pairs[:, 1], vals
