"""Fused dense CAVI sweep for the GPU: two Pallas kernels, Triton route.

The XLA dense path (ops/sweep.py::dense_sums) restates the reference hot
loop (hgaprec.cc:928-941) as SDDMM + two SpMMs and writes the f32 score
and weight tiles s = A B^T, W = Y / s through device memory between the
three matmuls (about 21 B per cell). These kernels keep s and W in
registers and read only the u8 count of each cell:

  user pass, grid (N / TU,):     for every item tile c of the catalog
                                     s = A_u B_c^T;  w = y / s
                                     acc_a[u] += w @ B_c
  item pass, grid (M / TC, G):   for every user tile u of group g
                                     s = A_u B_c^T;  w = y / s
                                     part_b[g, c] += w^T @ A_u
  acc_b = sum_g part_b[g]                                    (XLA)

Blocks run in parallel and in no order, so neither accumulator can be
carried across the grid; each pass owns one side and recomputes s (four
matmuls instead of three, two reads of the u8 count per cell). The item
pass splits the users into G groups so that narrow catalogs still fill
the card; the G partial [M, Kp] sums are reduced outside the kernel.

The kernels read Y through a free u16 view, two counts per element:
Pallas-Triton indexes arrays of up to 2^32 bytes with 32-bit signed
element offsets, which a u8 array past 2^31 bytes overflows (the 4 GiB
hybrid head of a million-user catalog), while its u16 view stays below
2^31 elements. The low bytes hold the even columns of a tile and the
high bytes the odd ones, so B's rows are permuted per tile to match
(evens first) and the item-side sums permuted back.

Returns the same accumulators as the XLA path: the linear-space sums of
y*phi before the final elementwise scaling, acc_a = W B and
acc_b = W^T A, which the caller multiplies by A and B.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE_U = 64     # user rows per block step
TILE_C = 64     # item columns per block step (two planes of TILE_C / 2)
MIN_BLOCKS = 1024   # item-pass grid size to aim for (132 SMs, a few waves)
MAX_KP = 128    # widest factor row (K, plus two bias columns) kept in
                # registers; wider models take the XLA path


def kernel_width(k: int, bias: bool) -> int:
    """Power-of-two row width of the factor tiles (Triton block dims)."""
    return max(16, pl.next_power_of_2(k + 2 if bias else k))


def _weights(a, b, y, prec):
    """w = y / (a b^T): zero where y == 0, including every padding cell.
    The clamp keeps the divide finite when a dot product underflows."""
    s = pl.dot(a, b, trans_b=True, precision=prec)
    return y.astype(jnp.float32) / jnp.maximum(s, 1e-30)


def _planes(v):
    """The two count planes of a tile of u16 words: even, odd columns."""
    return v & 0xFF, v >> 8


def _user_pass(a_ref, b_ref, y_ref, out_ref, *, tile_c, prec):
    a = a_ref[...]
    half = tile_c // 2

    def body(c, acc):
        y_even, y_odd = _planes(y_ref[:, pl.ds(c * half, half)])
        for y, start in ((y_even, c * tile_c), (y_odd, c * tile_c + half)):
            b = b_ref[pl.ds(start, half), :]
            w = _weights(a, b, y, prec)
            acc = acc + pl.dot(w.astype(b.dtype), b, precision=prec)
        return acc

    out_ref[...] = lax.fori_loop(0, b_ref.shape[0] // tile_c, body,
                                 jnp.zeros(out_ref.shape, jnp.float32))


def _item_pass(a_ref, b_ref, y_ref, out_ref, *, tile_u, steps, prec):
    half = b_ref.shape[0] // 2
    b_even, b_odd = b_ref[:half, :], b_ref[half:, :]
    lo = pl.program_id(1) * steps
    hi = jnp.minimum(lo + steps, a_ref.shape[0] // tile_u)

    def body(t, accs):
        rows = pl.ds(t * tile_u, tile_u)
        a = a_ref[rows, :]
        y_even, y_odd = _planes(y_ref[rows, :])
        return tuple(
            acc + pl.dot(_weights(a, b, y, prec).astype(a.dtype), a,
                         trans_a=True, precision=prec)
            for acc, b, y in zip(accs, (b_even, b_odd), (y_even, y_odd)))

    zero = jnp.zeros((half, out_ref.shape[1]), jnp.float32)
    acc_even, acc_odd = lax.fori_loop(lo, hi, body, (zero, zero))
    out_ref[:half, :] = acc_even
    out_ref[half:, :] = acc_odd


def _pad_to(x: jax.Array, rows: int, cols: int) -> jax.Array:
    pr, pc = rows - x.shape[0], cols - x.shape[1]
    if pr == 0 and pc == 0:
        return x
    return jnp.pad(x, ((0, pr), (0, pc)))


@functools.partial(jax.jit, static_argnames=("bf16", "tile_u", "tile_c",
                                             "num_warps", "num_stages",
                                             "interpret"))
def fused_dense_sweep(a_lin: jax.Array, b_lin: jax.Array,
                      dense_y: jax.Array, ba_lin=None, bb_lin=None,
                      *, bf16: bool = False,
                      tile_u: int = TILE_U, tile_c: int = TILE_C,
                      num_warps: int = 4, num_stages: int = 3,
                      interpret: bool = False) -> Tuple[jax.Array, ...]:
    """(W @ B, W^T @ A[, rowsum W, colsum W]) with W = Y/(A B^T [+ biases]).

    a_lin: f32[N, K] linear-space user factors (exp of Elog);
    b_lin: f32[M, K]; dense_y: u8[>=N, >=M] counts (rows/cols may be
    zero-padded at build time — see data/device.py); ba_lin/bb_lin:
    optional f32[N]/f32[M] linear-space bias expectations (the K+1/K+2
    phi slots, hgaprec.cc:223-239). bf16=True runs the matmuls on bf16
    operands with f32 accumulation; otherwise on f32 operands with IEEE
    f32 products. Caller applies the final elementwise scaling by
    a_lin/b_lin (and ba/bb). Returns 2 or 4 accumulators.
    """
    n, k = a_lin.shape
    m = b_lin.shape[0]
    bias = ba_lin is not None
    kp = kernel_width(k, bias)
    if dense_y.dtype != jnp.uint8:
        raise TypeError(f"dense_y must be uint8, got {dense_y.dtype}")
    if bias:
        # pack the bias expectations into the padding columns:
        # a = [A | ba | 1], b = [B | 1 | bb]. The score matmul then
        # includes ba + bb, and the accumulating matmuls deliver
        # rowsum(w) in acc_a[:, k] (w @ the ones column of b) and
        # colsum(w) in acc_b[:, k+1] — the bias statistics ride the
        # same products (cf. ops/mxu_tail._augment, same layout)
        a_lin = jnp.concatenate(
            [a_lin, ba_lin.reshape(-1, 1), jnp.ones((n, 1), a_lin.dtype)],
            axis=1)
        b_lin = jnp.concatenate(
            [b_lin, jnp.ones((m, 1), b_lin.dtype), bb_lin.reshape(-1, 1)],
            axis=1)
    # bf16 operands are cast once here (fused with the upstream exp); in
    # the bias variant this also rounds ba/bb and the rowsum/colsum(w)
    # statistics — the accepted bound is 2e-2 relative
    # (tests/test_dense_pallas.py::test_fused_bias_bf16_close_to_f32)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    prec = None if bf16 else lax.Precision.HIGHEST
    # Y often comes padded past N and M at build time: pad the factors
    # up to it rather than slicing Y, whose copy would cost a multi-GB
    # move every step; the extra rows meet only zero counts
    np_ = -(-max(n, dense_y.shape[0]) // tile_u) * tile_u
    mp = -(-max(m, dense_y.shape[1]) // tile_c) * tile_c
    n_tiles, c_tiles = np_ // tile_u, mp // tile_c
    half = tile_c // 2
    a = _pad_to(a_lin.astype(dt), np_, kp)
    # evens first within each item tile, as the u16 planes deliver them
    b = _pad_to(b_lin.astype(dt), mp, kp).reshape(
        c_tiles, half, 2, kp).transpose(0, 2, 1, 3).reshape(mp, kp)
    y = lax.bitcast_convert_type(
        _pad_to(dense_y, np_, mp).reshape(np_, mp // 2, 2), jnp.uint16)

    groups = max(1, min(n_tiles, -(-MIN_BLOCKS // c_tiles)))
    steps = -(-n_tiles // groups)
    groups = -(-n_tiles // steps)
    params = plgpu.CompilerParams(num_warps=num_warps,
                                  num_stages=num_stages)

    acc_a = pl.pallas_call(
        functools.partial(_user_pass, tile_c=tile_c, prec=prec),
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec((tile_u, kp), lambda u: (u, 0)),
                  pl.BlockSpec((mp, kp), lambda u: (0, 0)),
                  pl.BlockSpec((tile_u, mp // 2), lambda u: (u, 0))],
        out_specs=pl.BlockSpec((tile_u, kp), lambda u: (u, 0)),
        out_shape=jax.ShapeDtypeStruct((np_, kp), jnp.float32),
        compiler_params=params, backend="triton", interpret=interpret,
        name="dense_sweep_user_pass",
    )(a, b, y)
    part_b = pl.pallas_call(
        functools.partial(_item_pass, tile_u=tile_u, steps=steps, prec=prec),
        grid=(c_tiles, groups),
        in_specs=[pl.BlockSpec((np_, kp), lambda c, g: (0, 0)),
                  pl.BlockSpec((tile_c, kp), lambda c, g: (c, 0)),
                  pl.BlockSpec((np_, half), lambda c, g: (0, c))],
        out_specs=pl.BlockSpec((None, tile_c, kp), lambda c, g: (g, c, 0)),
        out_shape=jax.ShapeDtypeStruct((groups, mp, kp), jnp.float32),
        compiler_params=params, backend="triton", interpret=interpret,
        name="dense_sweep_item_pass",
    )(a, b, y)
    acc_b = jnp.sum(part_b, axis=0).reshape(
        c_tiles, 2, half, kp).transpose(0, 2, 1, 3).reshape(mp, kp)
    if bias:
        # rowsum(w) rode b's ones column (k); colsum(w) rode a's (k+1)
        return (acc_a[:n, :k], acc_b[:m, :k],
                acc_a[:n, k], acc_b[:m, k + 1])
    return acc_a[:n, :k], acc_b[:m, :k]
