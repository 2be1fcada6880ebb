"""The CAVI phi sweep — the reference hot loop, re-expressed as matmuls.

Reference behavior (hgaprec.cc:928-941 and get_phi at 206-239): for every
training nonzero (n, m, y), phi = softmax_k(Elog a[n] + Elog b[m] [+ bias
logits]), scaled by y, accumulated into the user-side and item-side shape
buffers (gpbase.hh:536-539).

Key identity used here: with A = exp(Elog a), B = exp(Elog b),
    sum_k exp(Elog a[n,k] + Elog b[m,k]) = (A @ B.T)[n, m]
so the per-nonzero softmax denominator is a *matmul*, and the accumulated
y*phi sufficient statistics are
    acc_a = A ⊙ (W @ B),   acc_b = B ⊙ (W.T @ A),   W = Y / (A@B.T + biases)
i.e. an SDDMM + two SpMMs. Execution paths:

  * dense:   stream tiles of a densified u8 Y through matmuls — the fused
             GPU kernel (ops/dense_pallas.py) or the XLA block scans
             (dense_sums); for catalogs whose [N, M] count matrix fits
             (MovieLens/Netflix item counts).
  * hybrid:  a dense block over the top-degree items plus a sparse tail.
  * segment: gather Elog rows per nonzero, log-softmax, segment-sum over
             the dual-sorted COO — the general sparse path and the
             correctness baseline for the others.

select_kernels picks the implementations from the backend and the shapes.
All return identical accumulators: the linear-space sums of y*phi.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from hgaprec_jax.data.device import DeviceData
from hgaprec_jax.ops.dense_pallas import (MAX_KP, fused_dense_sweep,
                                          kernel_width)
from hgaprec_jax.ops.mxu_tail import mxu_tail_sweep


class SweepResult(NamedTuple):
    acc_a: jax.Array               # [N, K] sum of y*phi over items of n
    acc_b: jax.Array               # [M, K] sum of y*phi over users of m
    acc_bias_a: Optional[jax.Array]  # [N] sum of y*phi[K]   (bias slot)
    acc_bias_b: Optional[jax.Array]  # [M] sum of y*phi[K+1]


def _pad_rows(x: jax.Array, rows: int) -> jax.Array:
    if x.shape[0] == rows:
        return x
    pad = [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def _user_block_of(rows: int, user_block: int) -> int:
    """Largest power-of-2 divisor of `rows`, capped at user_block.

    build_device_data pads dense_y rows to a multiple of 512 at build
    time, so on the fast path this yields a tile height >= 512. If the
    divisor degenerates anyway (caller passed unpadded rows, e.g. odd N),
    sweep_dense pads Y/factors in-jit to a 256-multiple first — a per-step
    copy of Y, correct but slow, hence the build-time padding."""
    if rows <= user_block:
        return rows
    ub = rows & (-rows)  # largest power-of-2 divisor
    while ub > user_block:
        ub //= 2
    return ub


def dense_sums(a: jax.Array, b: jax.Array, ba: Optional[jax.Array],
               bb: Optional[jax.Array], dense_y: jax.Array, *,
               item_block: int = 4096, user_block: int = 16384,
               precision: str = "highest") -> Tuple[jax.Array, ...]:
    """XLA form of the dense block sums: (W @ B, W^T @ A[, rowsum W,
    colsum W]) with W = Y / (A B^T [+ biases]), from linear-space
    factors a f32[N, K], b f32[M, K] and optional biases ba f32[N],
    bb f32[M]. Same contract as ops/dense_pallas.fused_dense_sweep.

    Two-level streaming: an outer scan over user blocks (reshape of Y —
    free, row-major) and an inner scan over item blocks, so the score
    tile is [user_block, item_block] regardless of N (at Netflix scale a
    single-level [N, item_block] f32 tile would exceed device memory)."""
    prec = None if precision == "default" else jax.lax.Precision.HIGHEST
    n, k = a.shape
    m = b.shape[0]
    if dense_y.shape[0] < n:
        raise ValueError(f"dense_y rows {dense_y.shape[0]} < factor rows "
                         f"{n}")
    dtype = a.dtype
    bias = ba is not None

    # dense_y rows may exceed n (row-padded at build time so user tiling
    # never degenerates); the extra rows are all-zero counts. Pad the
    # factor side to match — an O(N*K) f32 copy, negligible next to the
    # tile matmuls. If the row count STILL has no usable tile divisor
    # (unpadded odd N), pad Y itself in-jit as a correct slow path.
    n_store = dense_y.shape[0]
    if _user_block_of(n_store, user_block) < min(user_block, 256):
        n_store = -(-n_store // 256) * 256
        dense_y = _pad_rows(dense_y, n_store)
    if n_store != n:
        a = _pad_rows(a, n_store)
        if bias:
            ba = jnp.pad(ba, (0, n_store - n))

    # m_store: the dense matrix may be column-padded at build time so the
    # huge [N, M] array is sliced in place per block (no device-side copy
    # of Y — at Netflix scale a transpose/pad copy would double its
    # memory)
    m_store = dense_y.shape[1]
    nb = -(-m_store // item_block)
    mp = nb * item_block
    if mp != m_store:
        dense_y = jnp.pad(dense_y, ((0, 0), (0, mp - m_store)))
    b_pad = _pad_rows(b, mp)
    bb_pad = (_pad_rows(bb, mp) if bias else jnp.zeros((mp,), dtype))

    ub = _user_block_of(n_store, user_block)
    nu = n_store // ub
    y_r = dense_y.reshape(nu, ub, mp)
    a_r = a.reshape(nu, ub, k)
    ba_r = (ba if bias else jnp.zeros((n_store,), dtype)).reshape(nu, ub)

    def inner(carry, c, *, a_u, ba_u, y_u):
        acc_a_c, acc_ba_c = carry
        c0 = c * item_block
        b_blk = jax.lax.dynamic_slice_in_dim(b_pad, c0, item_block, 0)
        y_blk = jax.lax.dynamic_slice_in_dim(y_u, c0, item_block, 1)
        bb_blk = jax.lax.dynamic_slice_in_dim(bb_pad, c0, item_block, 0)
        y_blk = y_blk.astype(dtype)     # u8 counts -> f32, fused per tile
        s = jnp.dot(a_u, b_blk.T, preferred_element_type=jnp.float32,
                    precision=prec)                                # [UB, BI]
        if bias:
            s = s + ba_u[:, None] + bb_blk[None, :]
        w = jnp.where(y_blk > 0, y_blk / s, 0.0).astype(dtype)
        acc_a_c = acc_a_c + jnp.dot(w, b_blk, precision=prec,
                                    preferred_element_type=jnp.float32)
        acc_b_blk = jnp.dot(w.T, a_u, precision=prec,
                            preferred_element_type=jnp.float32)
        if bias:
            acc_ba_c = acc_ba_c + jnp.sum(w, axis=1)
            acc_bb_blk = jnp.sum(w, axis=0)
        else:
            acc_bb_blk = jnp.zeros((item_block,), dtype)
        return (acc_a_c, acc_ba_c), (acc_b_blk, acc_bb_blk)

    def outer(carry, xs):
        acc_b_tot, acc_bb_tot = carry
        a_u, ba_u, y_u = xs
        init = (jnp.zeros((ub, k), dtype), jnp.zeros((ub,), dtype))
        (acc_a_u, acc_ba_u), (b_blocks, bb_blocks) = jax.lax.scan(
            functools.partial(inner, a_u=a_u, ba_u=ba_u, y_u=y_u),
            init, jnp.arange(nb, dtype=jnp.int32))
        acc_b_tot = acc_b_tot + b_blocks.reshape(mp, k)
        acc_bb_tot = acc_bb_tot + bb_blocks.reshape(mp)
        return (acc_b_tot, acc_bb_tot), (acc_a_u, acc_ba_u)

    init = (jnp.zeros((mp, k), dtype), jnp.zeros((mp,), dtype))
    (acc_b_raw, acc_bb_raw), (acc_a_blocks, acc_ba_blocks) = jax.lax.scan(
        outer, init, (a_r, ba_r, y_r))

    acc_a = acc_a_blocks.reshape(n_store, k)[:n]
    if bias:
        return (acc_a, acc_b_raw[:m],
                acc_ba_blocks.reshape(n_store)[:n], acc_bb_raw[:m])
    return acc_a, acc_b_raw[:m]


def sweep_dense(elog_a: jax.Array, elog_b: jax.Array,
                elog_bias_a: Optional[jax.Array],
                elog_bias_b: Optional[jax.Array],
                dense_y: jax.Array, *, item_block: int = 4096,
                user_block: int = 16384,
                precision: str = "highest") -> SweepResult:
    """Dense-blocked XLA sweep. dense_y: u8/f32[N, >=M] counts (0 = none)."""
    a, b, ba, bb = _linear(elog_a, elog_b, elog_bias_a, elog_bias_b)
    return _scaled(a, b, ba, bb, dense_sums(
        a, b, ba, bb, dense_y, item_block=item_block,
        user_block=user_block, precision=precision))


def sweep_segment(elog_a: jax.Array, elog_b: jax.Array,
                  elog_bias_a: Optional[jax.Array],
                  elog_bias_b: Optional[jax.Array],
                  data: DeviceData) -> SweepResult:
    """Gather -> log-softmax -> dual segment-sum sweep over sorted COO."""
    n, k = elog_a.shape
    m = elog_b.shape[0]
    bias = elog_bias_a is not None

    la = elog_a[data.u_ids]                   # [P, K]
    lb = elog_b[data.i_ids]
    logits = la + lb
    if bias:
        cols = [logits, elog_bias_a[data.u_ids][:, None],
                elog_bias_b[data.i_ids][:, None]]
        logits = jnp.concatenate(cols, axis=1)   # [P, K+2]
    lse = jax.scipy.special.logsumexp(logits, axis=1, keepdims=True)
    phis = data.y[:, None] * jnp.exp(logits - lse)   # y * phi; 0 on padding

    acc_a = jax.ops.segment_sum(phis[:, :k], data.u_ids, num_segments=n,
                                indices_are_sorted=True)
    phis_i = phis[data.item_order]
    acc_b = jax.ops.segment_sum(phis_i[:, :k], data.i_ids_sorted,
                                num_segments=m, indices_are_sorted=True)
    if bias:
        acc_ba = jax.ops.segment_sum(phis[:, k], data.u_ids, num_segments=n,
                                     indices_are_sorted=True)
        acc_bb = jax.ops.segment_sum(phis_i[:, k + 1], data.i_ids_sorted,
                                     num_segments=m, indices_are_sorted=True)
        return SweepResult(acc_a, acc_b, acc_ba, acc_bb)
    return SweepResult(acc_a, acc_b, None, None)


# above this many padded nonzeros the [P, K] phi matrix is streamed in
# chunks (EchoNest: P ~ 48M, K = 100 -> 19 GB if materialized at once)
SEGMENT_CHUNK_THRESHOLD = 4 << 20
SEGMENT_CHUNK = 1 << 20


def sweep_segment_chunked(elog_a: jax.Array, elog_b: jax.Array,
                          elog_bias_a: Optional[jax.Array],
                          elog_bias_b: Optional[jax.Array],
                          data: DeviceData,
                          chunk: int = SEGMENT_CHUNK) -> SweepResult:
    """One-pass linear-space segment sweep streamed over nonzero chunks.

    Same accumulators as sweep_segment; the [P, K] phi tensor only ever
    exists [chunk, K] at a time. Two design decisions, both counting row
    operations per nonzero (the gathers, not their bytes, set the cost):

      * linear space: phi ∝ A[u] ⊙ B[i] with s = <A[u], B[i]> — the
        dense path's identity — instead of log-softmax; drops the
        logsumexp/exp chain.
      * one pass over the user-sorted stream: acc_a via sorted
        segment_sum, acc_b via unsorted scatter-add — instead of
        re-gathering and recomputing phi from the item-sorted stream
        (4 gathers + 2 segsums -> 2 gathers + 1 segsum + 1 scatter).

    vs the reference per-nonzero log-space loop (hgaprec.cc:928-941):
    values are identical up to f32 rounding; the 1e-30 clamp mirrors
    gpbase.hh make_nonzero. Zero-count padding rows contribute nothing
    (phi = 0)."""
    a_lin = jnp.exp(elog_a)
    b_lin = jnp.exp(elog_b)
    ba_lin = jnp.exp(elog_bias_a) if elog_bias_a is not None else None
    bb_lin = jnp.exp(elog_bias_b) if elog_bias_b is not None else None
    return _segment_onepass_lin(a_lin, b_lin, ba_lin, bb_lin,
                                data.u_ids, data.i_ids, data.y, chunk)


def _segment_onepass_lin(a_lin, b_lin, ba_lin, bb_lin,
                         u_ids, i_ids, y, chunk: int) -> SweepResult:
    """The one-pass linear-space COO sweep over a user-sorted stream.

    Shared by the chunked segment mode and the tail half of the hybrid
    mode. Inputs are linear-space expectations (exp of Elog)."""
    n, k = a_lin.shape
    m = b_lin.shape[0]
    bias = ba_lin is not None
    p = u_ids.shape[0]
    nc = -(-p // chunk)
    pp = nc * chunk

    def padi(x, fill):
        return (x if x.shape[0] == pp else
                jnp.pad(x, (0, pp - x.shape[0]), constant_values=fill))

    u_r = padi(u_ids, n - 1).reshape(nc, chunk)
    i_r = padi(i_ids, m - 1).reshape(nc, chunk)
    y_r = padi(y, 0.0).reshape(nc, chunk)

    def body(carry, xs):
        acc_a, acc_b, acc_ba, acc_bb = carry
        uu, ii, yy = xs
        av = a_lin[uu]                                   # [C, K]
        bv = b_lin[ii]
        prod = av * bv
        s = jnp.sum(prod, axis=1)
        if bias:
            bau = ba_lin[uu]
            bbi = bb_lin[ii]
            s = s + bau + bbi
        w = yy / jnp.maximum(s, 1e-30)                   # [C]
        ph = w[:, None] * prod
        acc_a = acc_a + jax.ops.segment_sum(ph, uu, num_segments=n,
                                            indices_are_sorted=True)
        acc_b = acc_b.at[ii].add(ph)
        if bias:
            acc_ba = acc_ba + jax.ops.segment_sum(
                w * bau, uu, num_segments=n, indices_are_sorted=True)
            acc_bb = acc_bb.at[ii].add(w * bbi)
        return (acc_a, acc_b, acc_ba, acc_bb), None

    dt = a_lin.dtype
    init = (jnp.zeros((n, k), dt), jnp.zeros((m, k), dt),
            jnp.zeros((n,), dt), jnp.zeros((m,), dt))
    (acc_a, acc_b, acc_ba, acc_bb), _ = jax.lax.scan(
        body, init, (u_r, i_r, y_r))
    if bias:
        return SweepResult(acc_a, acc_b, acc_ba, acc_bb)
    return SweepResult(acc_a, acc_b, None, None)


class Kernels(NamedTuple):
    """The implementations one sweep runs, as select_kernels names them."""
    block: str             # dense u8 blocks (dense mode, hybrid head):
                           # "fused" (ops/dense_pallas.py) | "xla"
    tail: Optional[str]    # hybrid tail: "mxu" (ops/mxu_tail.py) |
                           # "onepass" (_segment_onepass_lin); else None


def select_kernels(backend: str, mode: str, *, k: int, bias: bool,
                   precision: str = "highest",
                   compact_tail: bool = False) -> Kernels:
    """Choose the kernels of a sweep from the backend and the shapes.

    The fused dense kernel is compiled for the GPU (Triton route) and
    keeps a factor row of width kernel_width(k, bias) in registers, so it
    serves GPU runs whose rows fit MAX_KP, at precision "default" (bf16
    operands): with IEEE f32 operands its Triton matmuls run far slower
    than XLA's (Netflix on an H100: 12.8 s against 0.20 s per sweep).
    Every other backend, width or precision takes the XLA dense sums.
    The hybrid tail runs the scatter-free compact sweep whenever the
    compact stream was built (data/device.py builds it for every
    head/tail split), else the one-pass COO sweep."""
    fused = (backend == "gpu" and precision == "default"
             and kernel_width(k, bias) <= MAX_KP)
    tail = None
    if mode == "hybrid":
        tail = "mxu" if compact_tail else "onepass"
    return Kernels(block="fused" if fused else "xla", tail=tail)


def _linear(elog_a, elog_b, elog_bias_a, elog_bias_b):
    """exp of the log expectations (biases stay None when absent)."""
    bias = elog_bias_a is not None
    return (jnp.exp(elog_a), jnp.exp(elog_b),
            jnp.exp(elog_bias_a) if bias else None,
            jnp.exp(elog_bias_b) if bias else None)


def _scaled(a, b, ba, bb, raw) -> SweepResult:
    """Final elementwise scaling of the raw block sums by the factors."""
    if ba is not None:
        return SweepResult(a * raw[0], b * raw[1], ba * raw[2], bb * raw[3])
    return SweepResult(a * raw[0], b * raw[1], None, None)


def block_sums(impl: str, a, b, ba, bb, dense_y, *, item_block: int,
               user_block: int, precision: str) -> Tuple[jax.Array, ...]:
    """Raw sums of one dense u8 block through the chosen implementation."""
    if impl == "fused":
        return fused_dense_sweep(a, b, dense_y, ba, bb,
                                 bf16=(precision == "default"))
    return dense_sums(a, b, ba, bb, dense_y, item_block=item_block,
                      user_block=user_block, precision=precision)


def sweep_hybrid(elog_a: jax.Array, elog_b: jax.Array,
                 elog_bias_a: Optional[jax.Array],
                 elog_bias_b: Optional[jax.Array],
                 data: DeviceData, kernels: Kernels, *,
                 item_block: int = 4096, user_block: int = 16384,
                 precision: str = "highest",
                 chunk: int = SEGMENT_CHUNK) -> SweepResult:
    """Head/tail hybrid sweep for power-law catalogs too wide to densify.

    The reference's own analysis layer documents the heavy-tailed item
    popularity (marg.R NB fits); at NYT/EchoNest scale the head items
    carry most nonzeros. Build time splits the COO: nonzeros whose item
    is among the top-T by degree land in a dense uint8 [N, T] block
    (head_dense_y, columns = head_items) and run through the dense block
    kernel; the tail runs the compact sweep (ops/mxu_tail.py) when the
    compact stream was built, else the one-pass segment sweep. All paths
    share the identical denominator s = <A[u], B[i]> (+ biases), so the
    result equals the pure segment sweep up to summation order. Under
    precision "default" both halves take bf16 matmul operands with f32
    accumulation."""
    a_lin, b_lin, ba_lin, bb_lin = _linear(elog_a, elog_b, elog_bias_a,
                                           elog_bias_b)
    bias = ba_lin is not None
    head = data.head_items                       # i32[T]
    b_head = b_lin[head]                         # [T, K]
    bb_head = bb_lin[head] if bias else None
    raw = block_sums(kernels.block, a_lin, b_head, ba_lin, bb_head,
                     data.head_dense_y, item_block=item_block,
                     user_block=user_block, precision=precision)

    if kernels.tail == "mxu":
        tail = SweepResult(*mxu_tail_sweep(
            a_lin, b_lin, ba_lin, bb_lin, data.tail_compact,
            bf16=(precision == "default")))
    else:
        tail = _segment_onepass_lin(a_lin, b_lin, ba_lin, bb_lin,
                                    data.u_ids_tail, data.i_ids_tail,
                                    data.y_tail, chunk)

    acc_a = tail.acc_a + a_lin * raw[0]
    acc_b = tail.acc_b.at[head].add(b_head * raw[1])
    if bias:
        acc_ba = tail.acc_bias_a + ba_lin * raw[2]
        acc_bb = tail.acc_bias_b.at[head].add(bb_head * raw[3])
        return SweepResult(acc_a, acc_b, acc_ba, acc_bb)
    return SweepResult(acc_a, acc_b, None, None)


def sweep(elog_a, elog_b, elog_bias_a, elog_bias_b, data: DeviceData,
          mode: str, item_block: int = 4096, user_block: int = 16384,
          precision: str = "highest") -> SweepResult:
    kernels = select_kernels(
        jax.default_backend(), mode, k=elog_a.shape[1],
        bias=elog_bias_a is not None, precision=precision,
        compact_tail=data.tail_compact is not None)
    tiles = dict(item_block=item_block, user_block=user_block,
                 precision=precision)
    if mode == "dense":
        if data.dense_y is None:
            raise ValueError("dense sweep requested but dense_y not built")
        a, b, ba, bb = _linear(elog_a, elog_b, elog_bias_a, elog_bias_b)
        return _scaled(a, b, ba, bb, block_sums(
            kernels.block, a, b, ba, bb, data.dense_y, **tiles))
    if mode == "hybrid":
        if data.head_dense_y is None:
            raise ValueError("hybrid sweep requested but the head dense "
                             "block was not built (build_device_data "
                             "hybrid_head_items)")
        return sweep_hybrid(elog_a, elog_b, elog_bias_a, elog_bias_b,
                            data, kernels, **tiles)
    if (mode == "segment-chunked" or
            data.u_ids.shape[0] > SEGMENT_CHUNK_THRESHOLD):
        return sweep_segment_chunked(elog_a, elog_b, elog_bias_a,
                                     elog_bias_b, data)
    return sweep_segment(elog_a, elog_b, elog_bias_a, elog_bias_b, data)


def nonzero_logsumexp_sum(elog_a, elog_b, elog_bias_a, elog_bias_b,
                          data: DeviceData, weights: jax.Array) -> jax.Array:
    """sum over nonzeros of weights * logsumexp(logits) — ELBO helper.

    Matches the y^2 * lse collapse of the reference's phi-entropy term in
    logl() (hgaprec.cc:2217-2235); see models/elbo.py.
    """
    logits = elog_a[data.u_ids] + elog_b[data.i_ids]
    if elog_bias_a is not None:
        logits = jnp.concatenate(
            [logits, elog_bias_a[data.u_ids][:, None],
             elog_bias_b[data.i_ids][:, None]], axis=1)
    lse = jax.scipy.special.logsumexp(logits, axis=1)
    return jnp.sum(jnp.where(data.y > 0, weights * lse, 0.0))
