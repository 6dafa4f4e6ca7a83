"""Fused E-step kernel for NVIDIA Hopper (Pallas through Triton).

Computes the same logits as :func:`ops.likelihood.barcode_logits`:

    logits[b, g] = penalty[g] + Σ_{calls c of b} log(p[v_c, g]·(1−q_c) + max(q_c, 1e-4))

without ever writing the [calls, pseudogenotypes] intermediate to device
memory. Pseudogenotype columns are the singlets i and the donor pairs
(i, j), i < j, in :func:`ops.likelihood.pseudogenotype_mixing`'s order, so
the kernel walks the upper triangle of the donor × donor square in
``BLOCK_DONORS`` × ``BLOCK_DONORS`` tiles: the diagonal holds the singlets,
(p_i + p_i) / 2 = p_i, and the cells above it the doublets, (p_i + p_j) / 2,
both formed elementwise in f32 — no matrix unit, no TF32 — and equal bit for
bit to the f32 product with the {0, ½, 1} mixing matrix.

The grid is (pair tiles, barcode tiles), pair tiles fastest, so the
programs that share a barcode tile run side by side and read its calls'
genotype rows from L2. Calls arrive sorted by barcode, so each barcode's
calls are one contiguous run whose bounds come from a host prefix sum
(``offsets``). For each of its ``TILE_ROWS`` barcodes a program walks that
run in chunks of ``CHUNK`` calls, loads each call's two donor blocks as
contiguous rows of the genotype table, multiplies ``FOLD`` chunks' factors
into one product before the log, and sums over the calls.

Exactness:

* calls past the end of a run get q = 1, so their factor is exactly 1 and
  their log term exactly 0 (padding is a no-op);
* the log-product fold multiplies at most ``FOLD`` factors, each >= 1e-4
  (real calls) or exactly 1 (padding), so products stay normal f32 while
  FOLD <= 8; with sums taken in another order than on the XLA path, the two
  agree to f32 rounding (tests use rtol 1e-5).

The kernel compiles only for a GPU. ``interpret=True`` runs it in the Pallas
interpreter on any backend; tests use that, production never does.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Launch shape: the fastest of a sweep on an H100 at 32 donors, both at
# 65,536 barcodes × 4.2M calls and at 131,072 barcodes × 22M calls.
TILE_ROWS = 8
CHUNK = 16
BLOCK_DONORS = 16
FOLD = 4
NUM_WARPS = 4


def check_mixing(mixing: np.ndarray) -> bool:
    """True when ``mixing`` has doublet columns; raise unless canonical.

    The kernel derives every column's donor pair from its position, so the
    mixing matrix must be exactly :func:`pseudogenotype_mixing`'s: singlets
    in donor order, then every pair (i, j), i < j, in lexicographic order
    (or the singlets alone).
    """
    mixing = np.asarray(mixing)
    n_donors, n_pg = mixing.shape
    expected = [np.eye(n_donors, dtype=np.float32)]
    doublets = n_pg > n_donors
    if doublets:
        i, j = np.triu_indices(n_donors, k=1)
        pairs = np.zeros((n_donors, len(i)), dtype=np.float32)
        pairs[i, np.arange(len(i))] = 0.5
        pairs[j, np.arange(len(i))] = 0.5
        expected.append(pairs)
    if not np.array_equal(np.concatenate(expected, axis=1), mixing):
        raise ValueError("mixing must be pseudogenotype_mixing's canonical matrix")
    return doublets


def pair_tiles(n_donors: int, doublets: bool) -> np.ndarray:
    """[n_tiles, 2] first donors (i0, j0) of the tiles covering the columns.

    With doublets: every tile of the donor square on or above the diagonal.
    Singlets only: one row of tiles, i0 == j0, whose diagonal is the output.
    """
    starts = range(0, n_donors, BLOCK_DONORS)
    if not doublets:
        return np.array([(s, s) for s in starts], dtype=np.int32)
    return np.array([(a, b) for a in starts for b in starts if b >= a], dtype=np.int32)


@dataclass(frozen=True)
class CallRuns:
    """Host layout of barcode-sorted calls for the kernel.

    ``offsets[b]:offsets[b + 1]`` is barcode b's run of calls;
    ``n_barcodes_padded`` rounds up to whole tiles (padded barcodes own
    empty runs). ``vid``/``q`` carry ``FOLD * CHUNK`` calls of padding
    (vid 0, q 1) so that no load reads past the arrays.
    """

    offsets: np.ndarray  # i32 [n_barcodes_padded + 1]
    vid: np.ndarray  # i32 [n_calls + FOLD * CHUNK]
    q: np.ndarray  # f32 [n_calls + FOLD * CHUNK]
    n_barcodes: int

    @property
    def n_barcodes_padded(self) -> int:
        return len(self.offsets) - 1

    @classmethod
    def build(cls, cb_sorted, vid_sorted, q_sorted, n_barcodes: int,
              n_calls_padded: int = 0) -> "CallRuns":
        """Layout of ``n_barcodes`` barcodes' calls (cb-sorted columns).

        ``n_calls_padded`` (>= the call count) fixes the stream length, so
        that several shards' layouts stack into one array.
        """
        cb_sorted = np.asarray(cb_sorted)
        n_calls = len(cb_sorted)
        n_stream = max(n_calls, n_calls_padded)
        if n_calls and (cb_sorted[0] < 0 or cb_sorted[-1] >= n_barcodes):
            raise ValueError("barcode ids out of range")
        if n_calls and np.any(np.diff(cb_sorted) < 0):
            raise ValueError("calls must be sorted by barcode")
        pad = FOLD * CHUNK
        if n_stream + 2 * pad >= 2**31:
            raise ValueError("too many calls for int32 offsets")
        n_padded = -(-max(n_barcodes, 1) // TILE_ROWS) * TILE_ROWS
        offsets = np.searchsorted(
            cb_sorted, np.arange(n_padded + 1), side="left"
        ).astype(np.int32)
        vid = np.zeros(n_stream + pad, dtype=np.int32)
        vid[:n_calls] = vid_sorted
        q = np.ones(n_stream + pad, dtype=np.float32)
        q[:n_calls] = q_sorted
        return cls(offsets=offsets, vid=vid, q=q, n_barcodes=int(n_barcodes))


def _padded_donors(n_donors: int) -> int:
    return -(-n_donors // BLOCK_DONORS) * BLOCK_DONORS


def _estep_kernel(tiles_ref, off_ref, vid_ref, q_ref, gp_ref, pen_ref, out_ref,
                  *, n_donors: int, n_pg: int, doublets: bool):
    bd = BLOCK_DONORS
    pair = pl.program_id(0)
    tile = pl.program_id(1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (CHUNK,), 0)
    di = jax.lax.broadcasted_iota(jnp.int32, (bd,), 0)
    gi = tiles_ref[pair, 0] + di  # [bd] donors of the tile's rows
    gj = tiles_ref[pair, 1] + di  # [bd] donors of the tile's columns
    if doublets:
        # output column of cell (i, j): i on the diagonal, the pair index
        # D + i(2D − i − 1)/2 + (j − i − 1) above it
        row_i = gi[:, None]
        col_j = gj[None, :]
        keep = (row_i <= col_j) & (col_j < n_donors)
        cols = jnp.where(
            row_i == col_j, row_i,
            n_donors + row_i * (2 * n_donors - row_i - 1) // 2 + (col_j - row_i - 1),
        )
    else:
        keep = gi < n_donors
        cols = gi
    # cells outside the output (below the diagonal, past the last donor)
    # go to spare columns past n_pg, one per cell, so no two lanes of a
    # store share an address
    spare = n_pg + jnp.arange(keep.size, dtype=jnp.int32).reshape(keep.shape)
    pen = pen_ref[jnp.where(keep, cols, 0)]
    cols = jnp.where(keep, cols, spare)

    def factors(start, end):
        """Likelihood factors of calls start.. (exactly 1 from ``end`` on)."""
        live = start + lane < end
        vid = vid_ref[pl.ds(start, CHUNK)]
        q = jnp.where(live, q_ref[pl.ds(start, CHUNK)], 1.0)
        p_i = gp_ref[vid[:, None], gi[None, :]]  # [CHUNK, bd]
        keep_q = (1.0 - q)[:, None]
        floor_q = jnp.maximum(q, 1e-4)[:, None]
        if not doublets:
            return p_i * keep_q + floor_q
        p_j = gp_ref[vid[:, None], gj[None, :]]
        p = (p_i[:, :, None] + p_j[:, None, :]) * 0.5  # [CHUNK, bd, bd]
        return p * keep_q[:, :, None] + floor_q[:, :, None]

    def one_row(r, carry):
        b = tile * TILE_ROWS + r
        start = off_ref[b]
        end = off_ref[b + 1]
        step = FOLD * CHUNK

        def one_step(k, acc):
            s = start + k * step
            prod = factors(s, end)
            for f in range(1, FOLD):
                prod = prod * factors(s + f * CHUNK, end)
            return acc + jnp.sum(jnp.log(prod), axis=0)

        n_steps = (end - start + step - 1) // step
        acc = jax.lax.fori_loop(0, n_steps, one_step, jnp.zeros(cols.shape, jnp.float32))
        out_ref[b, cols] = acc + pen
        return carry

    jax.lax.fori_loop(0, TILE_ROWS, one_row, 0)


@partial(jax.jit, static_argnames=("n_barcodes", "doublets", "interpret"))
def _estep_call(gp, penalties, offsets, vid, q, *, n_barcodes: int, doublets: bool,
                interpret: bool):
    n_variants, n_donors = gp.shape
    n_pg = penalties.shape[0]
    n_padded = offsets.shape[0] - 1
    dp = _padded_donors(n_donors)
    gp = jnp.pad(gp.astype(jnp.float32), ((0, 0), (0, dp - n_donors)))
    tiles = jnp.asarray(pair_tiles(n_donors, doublets))
    spare = BLOCK_DONORS * BLOCK_DONORS if doublets else BLOCK_DONORS
    # the kernel addresses both tables with int32 element offsets
    if n_padded * (n_pg + spare) >= 2**31 or n_variants * dp >= 2**31:
        raise ValueError(
            f"E-step kernel tables too large for int32 offsets ({n_padded} barcode "
            f"rows x {n_pg + spare} columns, {n_variants} variants x {dp} donors); "
            "shard the barcodes over more devices"
        )
    out = pl.pallas_call(
        partial(_estep_kernel, n_donors=n_donors, n_pg=n_pg, doublets=doublets),
        grid=(tiles.shape[0], n_padded // TILE_ROWS),
        out_shape=jax.ShapeDtypeStruct((n_padded, n_pg + spare), jnp.float32),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="demux_estep",
    )(tiles, offsets, vid, q, gp, penalties.astype(jnp.float32))
    return out[:n_barcodes, :n_pg]


def resolve_use_pallas(flag) -> tuple:
    """(use the kernel, interpret it) for an engine's ``use_pallas`` value.

    None: the kernel on a GPU, the XLA path elsewhere. True: the kernel,
    raising where it cannot compile. False: the XLA path. "interpret": the
    kernel in the Pallas interpreter (tests).
    """
    if flag == "interpret":
        return True, True
    if flag is None:
        return jax.default_backend() == "gpu", False
    if flag:
        check_backend(interpret=False)
    return bool(flag), False


def check_backend(interpret: bool) -> None:
    """Raise unless the kernel can run: compiled on a GPU, or interpreted."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            f"the E-step kernel compiles only for a GPU (backend is "
            f"{jax.default_backend()!r}); use the XLA path or interpret=True"
        )


def estep_logits(genotype_prob, penalties, offsets, vid, q, *, n_barcodes: int,
                 doublets: bool, interpret: bool = False):
    """Logits [n_barcodes, n_pg] from a genotype table and a :class:`CallRuns`.

    ``doublets`` comes from :func:`check_mixing`; ``penalties`` has one
    entry per column. Traceable: callers fuse it with ``probs_from_betas``
    in one program.
    """
    check_backend(interpret)
    return _estep_call(
        genotype_prob, penalties, offsets, vid, q,
        n_barcodes=n_barcodes, doublets=doublets, interpret=interpret,
    )
