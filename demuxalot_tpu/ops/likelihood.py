"""Device-side demultiplexing math: genotype probs, doublet model, logits.

The core computation is, per barcode b and pseudo-genotype g:

    logits[b, g] = penalty[g] + Σ_{calls c of b} log(p[v_c, g]·(1−q_c) + max(q_c, 1e-4))

with p[v, g] the per-variant genotype probability — for a doublet column
(g1, g2) the mean of the two donors. The plain-XLA structure: gather the
two donor probabilities of every column per call, average them
elementwise, take the log, and segment-sum into barcode rows (calls
pre-sorted by barcode). The fused GPU kernel for the same sum lives in
``estep_kernel.py``; this module is the XLA path and the numerical
reference (mirrors demuxalot/demux.py:158-274).

All functions are pure and jit-friendly (static shapes, no data-dependent
control flow), usable directly or inside shard_map.
"""
from __future__ import annotations

import math
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_CALL_CHUNK = 256 * 1024

# ---------------------------------------------------------------------------
# Host-side model setup (tiny, numpy)
# ---------------------------------------------------------------------------

def doublet_penalties(n_genotypes: int, doublet_prior: float) -> np.ndarray:
    """Per-pseudogenotype logit corrections establishing the doublet prior.

    Chosen so the softmax prior mass on singlets is exactly
    ``1 - doublet_prior`` regardless of donor count
    (reference: demuxalot/demux.py:158-173).
    """
    assert 0 <= doublet_prior < 1
    if doublet_prior == 0:
        return np.zeros(n_genotypes, dtype="float32")

    doublet_logit_bonus = math.log(n_genotypes * doublet_prior)
    doublet_logit_bonus -= math.log(n_genotypes * max(n_genotypes - 1, 1) / 2 * (1 - doublet_prior))
    n_options = n_genotypes * (n_genotypes + 1) // 2  # singlets first, then doublets
    penalties = np.zeros(n_options, dtype="float32")
    penalties[n_genotypes:] = doublet_logit_bonus
    return penalties


def pseudogenotype_mixing(
    genotype_names: List[str], doublet_prior: float
) -> Tuple[np.ndarray, List[str]]:
    """Mixing matrix [n_donors, n_pseudogenotypes] and column names.

    Column g of the matrix expresses pseudo-genotype g's variant probability
    as a combination of donor probabilities: identity for singlets, 0.5/0.5
    for unordered donor pairs — so ``gathered_probs @ M`` expands the doublet
    axis in one matmul. Column order matches the reference enumeration
    (demuxalot/demux.py:175-191): singlets in donor order, then pairs (i, j)
    with i < j, named 'A+B'.
    """
    n = len(genotype_names)
    names = list(genotype_names)
    columns = [np.eye(n, dtype="float32")]
    if doublet_prior != 0:
        assert doublet_prior > 0
        pair_cols = []
        for i, g1 in enumerate(genotype_names):
            for j, g2 in enumerate(genotype_names):
                if i < j:
                    col = np.zeros(n, dtype="float32")
                    col[i] = 0.5
                    col[j] = 0.5
                    pair_cols.append(col)
                    names.append(f"{g1}+{g2}")
        if pair_cols:  # a single donor has no doublet columns
            columns.append(np.stack(pair_cols, axis=1))
    return np.concatenate(columns, axis=1), names


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------

# windowed denominators stay cheap only while SNP runs are short; genuine
# data has at most 4 variants (bases) per site, so anything past this cap
# falls back to the segment-sum path
MAX_WINDOWED_RUN = 6


def probs_from_betas(
    betas: jnp.ndarray,  # f32 [n_variants, n_donors]
    variant2snp: jnp.ndarray,  # i32 [n_variants]
    n_snps: int,
    p_genotype_clip: float,
    max_per_snp: int = 0,
) -> jnp.ndarray:
    """Per-donor variant probability: beta / Σ betas of the same SNP, clipped.

    ``max_per_snp > 0`` asserts (statically) that ``variant2snp`` is
    non-decreasing with at most that many variants per SNP — the layout
    :class:`ops.packing.VariantReindex` produces. The denominator then
    becomes a windowed sum of shifted rows: pure elementwise work instead of
    a segment-sum scatter plus a gather. 0 = no ordering assumption.

    (reference: demuxalot/demux.py:267-274)
    """
    if 0 < max_per_snp <= MAX_WINDOWED_RUN:
        n = betas.shape[0]
        # one fused elementwise expression: every shifted neighbor arrives
        # as a full-width padded roll, masked by SNP-run membership (an
        # .at[slice].add form compiles to per-shift dynamic-update-slices
        # that XLA does not fuse)
        denom = betas
        for d in range(1, min(max_per_snp, max(n, 1))):
            run = variant2snp[d:] == variant2snp[:-d]
            same = jnp.pad(run, (0, d))[:, None]
            fwd = jnp.pad(betas[d:], ((0, d), (0, 0)))
            denom = denom + jnp.where(same, fwd, 0.0)
            same_b = jnp.pad(run, (d, 0))[:, None]
            bwd = jnp.pad(betas[:-d], ((d, 0), (0, 0)))
            denom = denom + jnp.where(same_b, bwd, 0.0)
        probs = betas / jnp.clip(denom, min=1e-7)
        return jnp.clip(probs, p_genotype_clip, 1 - p_genotype_clip)
    denom = jax.ops.segment_sum(betas, variant2snp, num_segments=n_snps)
    probs = betas / jnp.clip(denom[variant2snp], min=1e-7)
    return jnp.clip(probs, p_genotype_clip, 1 - p_genotype_clip)


def expand_pseudogenotypes(
    genotype_prob: jnp.ndarray,  # f32 [n_variants, n_donors]
    mixing: jnp.ndarray,  # f32 [n_donors, n_pseudogenotypes]
    variant_id: jnp.ndarray,  # i32 [n_calls]
) -> jnp.ndarray:
    """Per-call pseudo-genotype probabilities [n_calls, n_pseudogenotypes].

    Every column of :func:`pseudogenotype_mixing` is a singlet (one 1) or a
    donor pair (two ½), so ``genotype_prob[vid] @ mixing`` is computed
    exactly as (p_i + p_j) / 2 over each column's two donor indices (i = j
    for a singlet) — elementwise f32, no matrix unit and therefore no
    reduced-precision (TF32/bf16) pass. Equal bit for bit to the f32 product.
    """
    n_donors = mixing.shape[0]
    nonzero = mixing != 0
    ii = jnp.argmax(nonzero, axis=0)
    jj = n_donors - 1 - jnp.argmax(nonzero[::-1], axis=0)
    rows = variant_id[:, None]
    return (genotype_prob[rows, ii[None, :]] + genotype_prob[rows, jj[None, :]]) * 0.5


def _pad_chunks(n: int, chunk: int) -> int:
    return -(-n // chunk)


def _accumulate_in_chunks(init, arrays, pad_values, call_chunk, contribution):
    """Sum ``contribution(*chunk)`` over fixed-size chunks of the call arrays.

    The single scaffolding for every chunked call reduction: bounds the
    materialized [chunk, n_pseudogenotypes] intermediate via a lax.scan,
    padding each array with its designated no-op value (see the module
    invariant: padding must contribute exactly zero).
    """
    (n_calls,) = arrays[0].shape
    if n_calls == 0:
        return init
    if n_calls <= call_chunk:
        return init + contribution(*arrays)

    n_chunks = _pad_chunks(n_calls, call_chunk)
    pad = n_chunks * call_chunk - n_calls
    chunks = tuple(
        jnp.pad(array, (0, pad), constant_values=fill).reshape(n_chunks, call_chunk)
        for array, fill in zip(arrays, pad_values)
    )

    def body(acc, chunk):
        return acc + contribution(*chunk), None

    acc, _ = jax.lax.scan(body, init, chunks)
    return acc


def barcode_logits(
    genotype_prob: jnp.ndarray,  # f32 [n_variants, n_donors]
    mixing: jnp.ndarray,  # f32 [n_donors, n_pseudogenotypes]
    penalties: jnp.ndarray,  # f32 [n_pseudogenotypes]
    variant_id: jnp.ndarray,  # i32 [n_calls], sorted by barcode
    cb: jnp.ndarray,  # i32 [n_calls], non-decreasing
    q: jnp.ndarray,  # f32 [n_calls], padding rows have q == 1
    n_barcodes: int,
    call_chunk: int = DEFAULT_CALL_CHUNK,
) -> jnp.ndarray:
    """Accumulate log-likelihood logits [n_barcodes, n_pseudogenotypes].

    Scans over fixed-size call chunks to bound the materialized
    [chunk, n_pseudogenotypes] intermediate; each chunk contributes via a
    sorted segment-sum. Padding calls (q=1) contribute log(1) = 0 exactly.
    """
    n_pg = mixing.shape[1]
    logits0 = jnp.zeros((n_barcodes, n_pg), jnp.float32) + penalties[None, :]
    return _accumulate_in_chunks(
        logits0,
        (variant_id, cb, q),
        (0, 0, 1.0),  # padding calls: q = 1 -> log(1) = 0
        call_chunk,
        lambda vid_c, cb_c, q_c: _chunk_contribution(
            genotype_prob, mixing, vid_c, cb_c, q_c, n_barcodes
        ),
    )


def _chunk_contribution(genotype_prob, mixing, variant_id, cb, q, n_barcodes):
    p = expand_pseudogenotypes(genotype_prob, mixing, variant_id)  # [c, pg]
    vals = jnp.log(p * (1.0 - q)[:, None] + jnp.clip(q, min=1e-4)[:, None])
    return jax.ops.segment_sum(vals, cb, num_segments=n_barcodes, indices_are_sorted=True)


def snp_aggregated_logits(
    genotype_prob: jnp.ndarray,  # f32 [n_variants, n_donors]
    mixing: jnp.ndarray,  # f32 [n_donors, n_pseudogenotypes]
    variant_id: jnp.ndarray,  # i32 [n_calls], sorted by group
    q: jnp.ndarray,  # f32 [n_calls] p_base_wrong per molecule call
    group_of_call: jnp.ndarray,  # i32 [n_calls], non-decreasing; padding -> n_groups
    barcode_of_group: jnp.ndarray,  # i32 [n_groups], non-decreasing
    group_molecules: jnp.ndarray,  # f32 [n_groups] molecule count per group
    n_groups: int,
    n_barcodes: int,
    compensation: float,
    p_bad_snp: float = 0.01,
    call_chunk: int = DEFAULT_CALL_CHUNK,
) -> jnp.ndarray:
    """Device port of the per-SNP aggregation path (ref demux.py:193-244).

    Per (barcode, snp) group: sum call log-likelihoods, damp by
    molecule-count**compensation, log-softmax, floor with a bad-SNP escape
    hatch, log-softmax again, then collapse groups onto barcodes. Groups
    arrive pre-sorted by (barcode, snp); padding calls carry
    ``group_of_call == n_groups`` and are dropped by the segment sum.
    Doublet penalties are intentionally NOT applied — the reference computes
    but never adds them on this path (demuxalot/demux.py:239-244).
    """
    n_pg = mixing.shape[1]

    def chunk_group_sums(vid_c, q_c, grp_c):
        p = expand_pseudogenotypes(genotype_prob, mixing, vid_c)
        vals = jnp.log(p + q_c[:, None])
        return jax.ops.segment_sum(vals, grp_c, num_segments=n_groups, indices_are_sorted=True)

    group_logits = _accumulate_in_chunks(
        jnp.zeros((n_groups, n_pg), jnp.float32),
        (variant_id, q, group_of_call),
        (0, 0, n_groups),  # padding calls: out-of-range group -> dropped
        call_chunk,
        chunk_group_sums,
    )

    group_logits = group_logits / jnp.maximum(group_molecules, 1.0)[:, None] ** compensation
    group_logits = jax.nn.log_softmax(group_logits, axis=1)
    group_logits = jnp.logaddexp(group_logits, math.log(p_bad_snp / n_pg))
    group_logits = jax.nn.log_softmax(group_logits, axis=1)
    return jax.ops.segment_sum(
        group_logits, barcode_of_group, num_segments=n_barcodes, indices_are_sorted=True
    )


def genotype_addition_from_posteriors(
    posterior: jnp.ndarray,  # f32 [n_barcodes(global), n_pseudogenotypes]
    variant_id: jnp.ndarray,  # i32 [n_calls], sorted by variant
    cb: jnp.ndarray,  # i32 [n_calls], GLOBAL barcode indices
    q: jnp.ndarray,  # f32 [n_calls], padding rows have q == 1
    n_variants: int,
    n_genotypes: int,
    contribution_power: float,
    call_chunk: int = DEFAULT_CALL_CHUNK,
) -> jnp.ndarray:
    """M-step sufficient statistics: posterior-weighted call counts per variant.

    Uses singlet posterior columns only; per call,
    ``(posterior[cb, g] · (1−q))**power`` scatter-added over the call's
    variant (reference: demuxalot/demux.py:113-118). Padding calls (q=1)
    contribute zero; the power is applied under a mask so it also holds for
    power ≤ 0.
    """
    singlet_posterior = posterior[:, :n_genotypes]

    def chunk_stats(vid_c, cb_c, q_c):
        w = singlet_posterior[cb_c] * (1.0 - q_c)[:, None]
        wp = w * w if contribution_power == 2.0 else w**contribution_power
        contrib = jnp.where(q_c[:, None] >= 1.0, 0.0, wp)
        return jax.ops.segment_sum(contrib, vid_c, num_segments=n_variants, indices_are_sorted=True)

    return _accumulate_in_chunks(
        jnp.zeros((n_variants, n_genotypes), jnp.float32),
        (variant_id, cb, q),
        (0, 0, 1.0),  # padding calls: q = 1 -> weight 0
        call_chunk,
        chunk_stats,
    )
