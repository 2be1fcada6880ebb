"""Scatter-free sparse CAVI sweep for the big-sparse tail (compact ids).

The chunked segment sweep (ops/sweep.py::_segment_onepass_lin) pays an
item-side scatter-add plus a full [N, K] segment-sum per nonzero chunk.
This module removes EVERY scatter and segment-sum from the sweep by
running TWO symmetric passes over compact-id streams, one per sort
order:

  * ids are COMPACTED host-side (build_tail_compact): users that appear
    in the stream get dense ids 0..NA-1, items 0..MT-1, and the stream
    is kept in BOTH sort orders (user-sorted and item-sorted).
  * sorted compact ids increase by at most 1 per entry, so any chunk of
    C nonzeros spans < C compact rows of the sorted side's factor
    table. The per-chunk reduction onto that side is therefore a
    one-hot TRANSPOSE MATMUL onto a contiguous row window:
        contrib = G^T @ (y*phi),  G[j, r] = [ids[j] - ids[0] == r]
    accumulated with a dynamic_update_slice read-modify-write — matmul
    work plus a contiguous update, no scatter, exact f32 sums.
  * pass 1 (user-sorted) accumulates the user side; pass 2 (item-sorted)
    accumulates the item side. Both passes gather the two factor rows
    per nonzero (the irreducible cost) and recompute identical w = y / s — the
    gathered bf16/f32 row values are bitwise the same in both orders,
    so the two passes see the same phi.
  * chunks are processed R at a time per lax.scan step (a batched
    einsum reduction) so per-step sequencing overhead amortizes.

Bias terms ride the same matmuls via two augmented columns:
  a_hat = [A | ba | 1],  b_hat = [B | 1 | bb]
so  <a_hat, b_hat> = A.B + ba + bb  (the reference's K+2 phi slots,
hgaprec.cc:223-239), and y*phi's columns K / K+1 are exactly the bias
shape statistics — no separate bias reductions.

Matches the reference per-nonzero loop (hgaprec.cc:928-941) up to f32
summation order; equals _segment_onepass_lin on the same data (see
tests/test_mxu_tail.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

LANE = 128
DEF_CHUNK = 1024   # nonzeros per one-hot reduction block
DEF_BATCH = 64     # chunks per lax.scan step (batched einsum); the
                   # [R, C, C] one-hot block is 128 MB in bf16


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TailCompact:
    """Compact-id COO stream in both sort orders (host-built).

    cu/ci index into `users`/`items`; padding entries repeat the last
    real compact id (keeping the span-<C invariant) and carry y = 0 so
    they contribute nothing. (cu, ci, y) is user-sorted;
    (cu_i, ci_i, y_i) is the same stream item-sorted.
    """
    cu: jax.Array        # i32[PT] compact user id per nonzero, sorted
    ci: jax.Array        # i32[PT] compact item id per nonzero
    y: jax.Array         # f32[PT] counts (0 on padding)
    cu_i: jax.Array      # i32[PT] compact user id, item-sorted order
    ci_i: jax.Array      # i32[PT] compact item id, sorted
    y_i: jax.Array       # f32[PT]
    users: jax.Array     # i32[NA] active user ids (sorted)
    items: jax.Array     # i32[MT] active item ids (sorted)


def build_tail_compact(u: np.ndarray, i: np.ndarray, y: np.ndarray,
                       *, pad_multiple: int = DEF_CHUNK,
                       stream_pad_to: int = 0,
                       users_pad_to: int = 0,
                       items_pad_to: int = 0,
                       to_jax: bool = True) -> Optional[TailCompact]:
    """Compact a user-sorted COO stream. Returns None when empty
    (unless stream_pad_to forces an all-padding stream — the sharded
    SPMD layout needs every shard to carry identically-shaped leaves
    even when a shard's tail happens to be empty).

    stream_pad_to / users_pad_to / items_pad_to: pad the stream and the
    active-id lists to these exact lengths so every shard of a
    shard_map'ed mesh sees the same shapes (parallel/sharded.py).
    Stream padding repeats the last compact id with y = 0 (preserving
    sortedness and the span-<C invariant); id-list padding appends
    DISTINCT ascending ids past the last real one, so the expansion
    scatters keep their sorted/unique promises — in-bounds pads write
    zero rows over zero rows, out-of-bounds pads are dropped (JAX
    scatter semantics), and gathers of any in/out-of-bounds pad produce
    rows the stream never references.
    """
    if u.size == 0 and stream_pad_to == 0:
        return None
    if u.size == 0:
        # empty shard in an SPMD build: one fake nonzero with y = 0 on
        # ids 0/0 — contributes nothing, keeps every invariant
        u = np.zeros(1, np.int32)
        i = np.zeros(1, np.int32)
        y = np.zeros(1, np.float32)
    users, cu = np.unique(u, return_inverse=True)
    items, ci = np.unique(i, return_inverse=True)
    users = users.astype(np.int32)
    items = items.astype(np.int32)
    cu = cu.astype(np.int32)
    ci = ci.astype(np.int32)
    yf = y.astype(np.float32)
    if users_pad_to:
        if users_pad_to < users.size:
            raise ValueError(f"users_pad_to {users_pad_to} < {users.size}")
        ext = users_pad_to - users.size
        users = np.concatenate(
            [users, users[-1] + 1 + np.arange(ext, dtype=np.int32)])
    if items_pad_to:
        if items_pad_to < items.size:
            raise ValueError(f"items_pad_to {items_pad_to} < {items.size}")
        ext = items_pad_to - items.size
        items = np.concatenate(
            [items, items[-1] + 1 + np.arange(ext, dtype=np.int32)])
    order = np.argsort(ci, kind="stable")
    pt = -(-u.size // pad_multiple) * pad_multiple
    if stream_pad_to:
        if stream_pad_to < pt or stream_pad_to % pad_multiple:
            raise ValueError(f"stream_pad_to {stream_pad_to} invalid for "
                             f"nnz {u.size}, pad_multiple {pad_multiple}")
        pt = stream_pad_to
    pad = pt - u.size

    def hpad(x, fill):
        return np.concatenate([x, np.full(pad, fill, x.dtype)])

    conv = jnp.asarray if to_jax else np.asarray
    return TailCompact(
        cu=conv(hpad(cu, cu[-1])), ci=conv(hpad(ci, ci[-1])),
        y=conv(hpad(yf, 0.0)),
        cu_i=conv(hpad(cu[order], cu[order][-1])),
        ci_i=conv(hpad(ci[order], ci[order][-1])),
        y_i=conv(hpad(yf[order], 0.0)),
        users=conv(users.astype(np.int32)),
        items=conv(items.astype(np.int32)),
    )


def _augment(x: jax.Array, col_a: Optional[jax.Array],
             col_b: Optional[jax.Array], kp: int) -> jax.Array:
    """[R, K] -> [R, kp] with optional bias columns K and K+1."""
    cols = [x]
    if col_a is not None:
        cols.append(col_a[:, None])
        cols.append(col_b[:, None])
    x = jnp.concatenate(cols, axis=1) if len(cols) > 1 else x
    if x.shape[1] < kp:
        x = jnp.pad(x, ((0, 0), (0, kp - x.shape[1])))
    return x


def _half_sweep(p_t: jax.Array, o_t: jax.Array, pc: jax.Array,
                oc: jax.Array, y: jax.Array, *, chunk: int, batch: int,
                mm_dtype, prec) -> jax.Array:
    """Accumulate y*phi onto the SORTED (primary) side of a compact
    stream. p_t: [NP, kp] primary factor table (the side pc is sorted
    by); o_t: [NO, kp] other side; pc/oc/y: the stream. Returns
    f32[NP + chunk, kp] (padded window; caller slices [:NP])."""
    np_rows, kp = p_t.shape
    pt = pc.shape[0]
    mega = chunk * batch
    ptm = -(-pt // mega) * mega
    if ptm != pt:
        ext = ptm - pt
        pc = jnp.concatenate([pc, jnp.broadcast_to(pc[-1], (ext,))])
        oc = jnp.concatenate([oc, jnp.broadcast_to(oc[-1], (ext,))])
        y = jnp.concatenate([y, jnp.zeros((ext,), y.dtype)])
    steps = ptm // mega
    pc_r = pc.reshape(steps, batch, chunk)
    oc_r = oc.reshape(steps, batch, chunk)
    y_r = y.reshape(steps, batch, chunk)

    iota_c = lax.broadcasted_iota(jnp.int32, (1, 1, chunk), 2)

    def body(acc, xs):
        pcm, ocm, ym = xs                     # [R, C]
        pg = p_t[pcm].astype(jnp.float32)     # [R, C, kp] gather
        og = o_t[ocm].astype(jnp.float32)     # [R, C, kp] gather
        prod = pg * og
        s = jnp.sum(prod, axis=2)             # = A.B + ba + bb (aug cols)
        w = ym / jnp.maximum(s, 1e-30)        # y == 0 rows give w == 0
        ph = w[:, :, None] * prod             # y * phi, [R, C, kp]
        u0 = pcm[:, 0]                        # [R]
        g = (pcm[:, :, None] - u0[:, None, None] == iota_c
             ).astype(mm_dtype)               # [R, C, C] one-hot
        contrib = jnp.einsum(
            "rjc,rjk->rck", g, ph.astype(mm_dtype),
            preferred_element_type=jnp.float32,
            precision=prec)                   # [R, C, kp] segment sums

        # per-chunk accumulator read-modify-writes onto the window
        def upd(r, a):
            cur = lax.dynamic_slice(a, (u0[r], 0), (chunk, kp))
            return lax.dynamic_update_slice(a, cur + contrib[r],
                                            (u0[r], 0))

        return lax.fori_loop(0, batch, upd, acc), None

    init = jnp.zeros((np_rows + chunk, kp), jnp.float32)
    acc, _ = lax.scan(body, init, (pc_r, oc_r, y_r))
    return acc


def mxu_tail_sweep(a_lin: jax.Array, b_lin: jax.Array,
                   ba_lin: Optional[jax.Array],
                   bb_lin: Optional[jax.Array],
                   tc: TailCompact, *, chunk: int = DEF_CHUNK,
                   batch: int = DEF_BATCH, bf16: bool = False
                   ) -> Tuple[jax.Array, jax.Array,
                              Optional[jax.Array], Optional[jax.Array]]:
    """One sweep over the compact stream, both sides, scatter-free.

    a_lin/b_lin: f32[N, K]/[M, K] linear-space expectations (exp Elog);
    ba_lin/bb_lin: optional f32[N]/[M] bias expectations. Returns
    (acc_a [N,K], acc_b [M,K], acc_ba [N] | None, acc_bb [M] | None) —
    the y*phi sufficient statistics, same convention as
    ops.sweep._segment_onepass_lin.
    """
    n, k = a_lin.shape
    m = b_lin.shape[0]
    bias = ba_lin is not None
    kaug = k + 2 if bias else k
    kp = -(-kaug // LANE) * LANE
    na = tc.users.shape[0]
    mt = tc.items.shape[0]
    mm_dtype = jnp.bfloat16 if bf16 else jnp.float32
    prec = None if bf16 else lax.Precision.HIGHEST
    batch = max(1, min(batch, -(-tc.cu.shape[0] // chunk)))

    # compact factor tables, bias-augmented, lane-padded. Gathered row
    # values are identical in both passes, so phi is too.
    ones_a = jnp.ones((na,), a_lin.dtype) if bias else None
    ones_b = jnp.ones((mt,), b_lin.dtype) if bias else None
    a_t = _augment(a_lin[tc.users],
                   ba_lin[tc.users] if bias else None, ones_a, kp)
    b_t = _augment(b_lin[tc.items], ones_b,
                   bb_lin[tc.items] if bias else None, kp)
    a_t = a_t.astype(mm_dtype)
    b_t = b_t.astype(mm_dtype)

    hs = dict(chunk=chunk, batch=batch, mm_dtype=mm_dtype, prec=prec)
    acc_a_c = _half_sweep(a_t, b_t, tc.cu, tc.ci, tc.y, **hs)
    acc_b_c = _half_sweep(b_t, a_t, tc.ci_i, tc.cu_i, tc.y_i, **hs)

    # expand compact accumulators to full index space (unique-index set)
    acc_a = jnp.zeros((n, k), jnp.float32).at[tc.users].set(
        acc_a_c[:na, :k], unique_indices=True, indices_are_sorted=True, mode="drop")
    acc_b = jnp.zeros((m, k), jnp.float32).at[tc.items].set(
        acc_b_c[:mt, :k], unique_indices=True, indices_are_sorted=True, mode="drop")
    if bias:
        acc_ba = jnp.zeros((n,), jnp.float32).at[tc.users].set(
            acc_a_c[:na, k], unique_indices=True, indices_are_sorted=True, mode="drop")
        acc_bb = jnp.zeros((m,), jnp.float32).at[tc.items].set(
            acc_b_c[:mt, k + 1], unique_indices=True,
            indices_are_sorted=True, mode="drop")
        return acc_a, acc_b, acc_ba, acc_bb
    return acc_a, acc_b, None, None
