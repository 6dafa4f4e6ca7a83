"""Host-side packing: compressed SNP calls → dense device-ready arrays.

This is the boundary between the CPU ingest frontend and the device compute
path. It joins molecule calls against genotype variants, collapses them to
unique (variant, barcode) rows, applies the beta regularization priors, and
lays the result out as flat int32/float32 arrays — padded to static shapes
and pre-sorted along both reduction axes (barcode for the E-step segment
sum, variant for the M-step segment sum).

Semantics mirror the reference packing (demuxalot/demux.py:276-392):
searchsorted variant matching with unmatched calls dropped, per-group
probability products, and the (1 + data-prior + sum-normalized-betas)
× default_prior beta regularization.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..native.hostops import (
    collapse_calls, collapse_calls_keyed, group_sum_broadcast, match_compact,
    match_keys, sort_calls_by_cb, stable_argsort,
)
from ..utils.encoding import base_lookup


@dataclass
class MoleculeCalls:
    """Per-call records after variant matching (one row per molecule×variant)."""

    variant_id: np.ndarray  # int32 [n]
    snp_id: np.ndarray  # int32 [n]
    compressed_cb: np.ndarray  # int32 [n]
    molecule_id: np.ndarray  # int32 [n], for backtracking only
    p_base_wrong: np.ndarray  # float32 [n]
    p_molecule_aligned_wrong: np.ndarray  # float32 [n]

    def __len__(self):
        return len(self.variant_id)

    def __getitem__(self, key):
        # recarray-style field access for parity with reference call sites
        return getattr(self, key)


BARCODE_CALLS_DTYPE = np.dtype(
    [
        ("variant_id", "int32"),
        ("snp_id", "int32"),
        ("compressed_cb", "int32"),
        ("p_base_wrong", "float32"),
        ("barcode_variant_count", "int64"),
        ("barcode_snp_count", "float64"),
    ]
)


def match_calls_to_variants(
    chromosome2compressed_snp_calls,
    genotypes,
) -> MoleculeCalls:
    """Join raw calls to genotype variant ids; unmatched calls are dropped.

    Matching is per chromosome on the (position, base) key, like the
    reference's sorted searchsorted join (demuxalot/demux.py:334-358).
    """
    variant_index2snp_index = genotypes.get_snp_ids_for_variants()
    # gather target dtype up front so per-chromosome snp gathers emit int32
    # directly (an astype on the gathered 22M-row result would copy ~90 MB)
    v2s_i32 = np.ascontiguousarray(variant_index2snp_index, dtype=np.int32)

    # per-chromosome sorted (pos*5 + base_code) key -> variant id, read
    # straight off the registry columns (no per-variant Python iteration)
    chrom_names, chrom_slots, positions, base_chars, base_slots = genotypes.variant_columns()
    # registry base chars -> call base codes; exotic bases get a sentinel
    # code that no call (0..4) can produce, so they simply never match
    slot2code = np.array([base_lookup.get(ch, 5) for ch in base_chars], dtype=np.int64)
    base_codes = slot2code[np.asarray(base_slots, dtype=np.int64)]
    chrom2keys: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    all_vids = np.arange(len(positions), dtype=np.int64)
    for slot, chrom in enumerate(chrom_names):
        sel = np.asarray(chrom_slots) == slot
        keys = np.asarray(positions, dtype=np.int64)[sel] * 6 + base_codes[sel]
        chrom2keys[chrom] = (keys, all_vids[sel])

    collected = {name: [] for name in (
        "variant_id", "snp_id", "compressed_cb", "molecule_id", "p_base_wrong", "p_molecule_aligned_wrong",
    )}

    for chromosome, compressed in chromosome2compressed_snp_calls.items():
        compressed.minimize_memory_footprint()
        calls = compressed.snp_calls
        molecules = compressed.molecules
        if chromosome not in chrom2keys or len(calls) == 0:
            continue
        table_keys, table_vids = chrom2keys[chromosome]
        native = match_compact(table_keys, table_vids, calls, molecules)
        if native is not None:
            # fused C++ join: key build + hash lookup + compaction +
            # molecule-field gathers in one pass (native/hostops.cpp)
            vid_m, cb_m, mol_m, p_m, pmol_m = native
            if not len(vid_m):
                continue
            collected["variant_id"].append(vid_m)
            collected["snp_id"].append(v2s_i32[vid_m])
            collected["compressed_cb"].append(cb_m)
            collected["molecule_id"].append(mol_m)
            collected["p_base_wrong"].append(p_m)
            collected["p_molecule_aligned_wrong"].append(pmol_m)
            continue
        call_keys = calls["snp_position"].astype(np.int64) * 6 + calls["base_index"].astype(np.int64)
        # hash join (native; searchsorted fallback): vid per call or -1
        joined = match_keys(table_keys, table_vids, call_keys)
        matched = joined >= 0
        if not matched.any():
            continue
        variant_id = joined[matched].astype(np.int32)
        mol_index = calls["molecule_index"][matched]

        collected["variant_id"].append(variant_id)
        collected["snp_id"].append(v2s_i32[variant_id])
        collected["compressed_cb"].append(molecules["compressed_cb"][mol_index])
        collected["molecule_id"].append(mol_index)
        collected["p_base_wrong"].append(calls["p_base_wrong"][matched])
        collected["p_molecule_aligned_wrong"].append(molecules["p_group_misaligned"][mol_index])

    def cat(name, dtype):
        chunks = collected[name]
        if not chunks:
            return np.empty(0, dtype=dtype)
        # chunks already carry the target dtype on the native path: no copy
        arr = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        return arr.astype(dtype, copy=False)

    return MoleculeCalls(
        variant_id=cat("variant_id", np.int32),
        snp_id=cat("snp_id", np.int32),
        compressed_cb=cat("compressed_cb", np.int32),
        molecule_id=cat("molecule_id", np.int32),
        p_base_wrong=cat("p_base_wrong", np.float32),
        p_molecule_aligned_wrong=cat("p_molecule_aligned_wrong", np.float32),
    )


def _group_boundaries(sorted_keys: np.ndarray) -> np.ndarray:
    """Start indices of equal-key runs in a sorted array."""
    if len(sorted_keys) == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.empty(len(sorted_keys), dtype=bool)
    starts[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=starts[1:])
    return np.flatnonzero(starts)


def molecule_calls_to_barcode_calls(molecule_calls: MoleculeCalls) -> np.recarray:
    """Collapse molecule calls to unique (variant, snp, barcode) rows.

    ``p_base_wrong`` of a row is the product over its molecules' values;
    counts per row and per (snp, barcode) ride along
    (reference: demuxalot/demux.py:276-300). Implemented with sort +
    reduceat — np.unique(return_inverse/counts) measures ~10x slower at
    millions of rows on this numpy build.
    """
    n = len(molecule_calls)
    cb_span = int(molecule_calls.compressed_cb.max()) + 1 if n else 1
    native = collapse_calls(
        molecule_calls.variant_id, molecule_calls.compressed_cb,
        molecule_calls.snp_id, molecule_calls.p_base_wrong,
    ) if n else None
    if native is not None:
        # fused C++ pass (native/hostops.cpp): same group order (sorted by
        # (variant, barcode)) and bit-identical stable-order f32 products
        out_vid, out_cb, out_snp, p_base_wrong, barcode_variant_counts = native
        n_groups = len(out_vid)
    else:
        vid = molecule_calls.variant_id.astype(np.int64)
        cb = molecule_calls.compressed_cb.astype(np.int64)
        group_key = vid * cb_span + cb

        order = stable_argsort(group_key)
        sorted_keys = group_key[order]
        starts = _group_boundaries(sorted_keys)
        n_groups = len(starts)
        unique_keys = sorted_keys[starts]
        barcode_variant_counts = np.diff(np.append(starts, n))

        out_vid = (unique_keys // cb_span).astype(np.int32)
        out_cb = (unique_keys % cb_span).astype(np.int32)
        # snp_id is a function of variant_id: take it from the first member row
        out_snp = molecule_calls.snp_id[order[starts]] if n else np.zeros(0, np.int32)

        # probability of a wrong base = product of member molecules' probabilities
        if n:
            p_base_wrong = np.multiply.reduceat(
                molecule_calls.p_base_wrong[order], starts
            ).astype("float32")
        else:
            p_base_wrong = np.zeros(0, "float32")

    # molecules per (snp, barcode), broadcast back to rows (f64 sums of
    # small int counts are exact, so native/numpy agree bit-for-bit)
    snp_cb_key = out_snp.astype(np.int64) * cb_span + out_cb
    weights = barcode_variant_counts.astype(np.float64)
    barcode_snp_count = group_sum_broadcast(snp_cb_key, weights) if n_groups else None
    if barcode_snp_count is None:
        if n_groups:
            order2 = stable_argsort(snp_cb_key)
            sorted2 = snp_cb_key[order2]
            starts2 = _group_boundaries(sorted2)
            sums2 = np.add.reduceat(weights[order2], starts2)
            # map each row to its (snp, barcode) group sum
            group_of_sorted = np.zeros(n_groups, dtype=np.int64)
            group_of_sorted[starts2] = 1
            group_of_sorted = np.cumsum(group_of_sorted) - 1
            barcode_snp_count = np.empty(n_groups, dtype=np.float64)
            barcode_snp_count[order2] = sums2[group_of_sorted]
        else:
            barcode_snp_count = np.zeros(0, dtype=np.float64)

    result = np.recarray(n_groups, dtype=BARCODE_CALLS_DTYPE)
    result["variant_id"] = out_vid
    result["snp_id"] = out_snp
    result["compressed_cb"] = out_cb
    result["p_base_wrong"] = p_base_wrong
    result["barcode_variant_count"] = barcode_variant_counts
    result["barcode_snp_count"] = barcode_snp_count
    return result


@dataclass
class CallColumns:
    """Collapsed (variant, barcode) call rows as contiguous SoA columns.

    The AoS recarray (``BARCODE_CALLS_DTYPE``, 32-byte rows) makes every
    column extraction at product scale scan ~700 MB; the device layout
    builders only ever touch these four columns, so the engine path keeps
    them as separate contiguous arrays. ``vid`` holds DEVICE (SNP-sorted)
    variant ids and rows are sorted by (vid, cb) — exactly the M-step
    stream order, and one key sort away from the E-step's barcode-major
    order (:meth:`by_barcode`).
    """

    vid: np.ndarray  # int32 [n], device variant ids, non-decreasing
    cb: np.ndarray  # int32 [n]
    q: np.ndarray  # float32 [n], p_base_wrong product per row
    count: np.ndarray  # int64 [n], molecules collapsed into the row

    def __len__(self):
        return len(self.vid)

    def by_barcode(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cb, vid, q) stably re-sorted to barcode-major order."""
        return sort_calls_by_cb(self.cb, self.vid, self.q)


def collapse_device_order(molecule_calls: MoleculeCalls, reindex: "VariantReindex") -> CallColumns:
    """Collapse molecule calls straight into device variant order.

    Groups and per-group stable f32 products are identical to
    :func:`molecule_calls_to_barcode_calls` (the variant renumbering is a
    bijection); only the row order differs — sorted by (device vid, cb)
    instead of (registry vid, cb), which is the order the M-step layout
    consumes with no further sort.
    """
    n = len(molecule_calls)
    if n == 0:
        return CallColumns(
            vid=np.empty(0, np.int32), cb=np.empty(0, np.int32),
            q=np.empty(0, np.float32), count=np.empty(0, np.int64),
        )
    cb = molecule_calls.compressed_cb
    cb_bits = max(1, int(int(cb.max())).bit_length())
    vid, cb_out, q, count = collapse_calls_keyed(
        molecule_calls.variant_id, cb, molecule_calls.p_base_wrong,
        reindex.inverse, cb_bits,
    )
    return CallColumns(vid=vid, cb=cb_out, q=q, count=count)


def compute_prior_betas(
    genotypes,
    molecule_calls: MoleculeCalls,
    variant_index2snp_index: np.ndarray,
    add_data_prior: bool,
) -> np.ndarray:
    """Regularized betas: prior + (1 [+ data prior] + normalized sum) × default_prior.

    Matches demuxalot/demux.py:367-390; result is frozen (read-only) — EM
    accumulates into a separate addition array.
    """
    variant_index2betas = genotypes.get_betas()
    assert np.all(variant_index2betas >= 0), "bad genotypes provided, negative betas appeared"

    def normalize_over_snp(variant_counts, regularization=1.0):
        assert len(variant_counts) == len(variant_index2snp_index)
        snp_counts = np.bincount(variant_index2snp_index, weights=variant_counts)[variant_index2snp_index]
        return variant_counts / (snp_counts + regularization)

    prior_betas = 1.0  # baseline regularization
    if add_data_prior:
        # training only: molecule support counts as additional prior evidence
        variant_index2n_molecules = np.bincount(molecule_calls.variant_id, minlength=genotypes.n_variants)
        prior_betas = prior_betas + normalize_over_snp(variant_index2n_molecules, regularization=100.0)
    prior_betas = prior_betas + normalize_over_snp(variant_index2betas.sum(axis=1), regularization=100.0)
    addition = np.asarray(prior_betas)[:, np.newaxis] * genotypes.default_prior
    result = variant_index2betas + addition.astype(variant_index2betas.dtype)
    result.flags.writeable = False
    return result


def pack_calls(
    chromosome2compressed_snp_calls,
    genotypes,
    add_data_prior: bool,
):
    """Full packing pipeline; returns the same 4-tuple shape as the reference.

    (variant_index2snp_index, regularized_betas, molecule_calls, barcode_calls)
    """
    variant_index2snp_index = genotypes.get_snp_ids_for_variants()
    molecule_calls = match_calls_to_variants(chromosome2compressed_snp_calls, genotypes)
    barcode_calls = molecule_calls_to_barcode_calls(molecule_calls)
    variant_index2betas = compute_prior_betas(
        genotypes, molecule_calls, variant_index2snp_index, add_data_prior=add_data_prior
    )
    return variant_index2snp_index, variant_index2betas, molecule_calls, barcode_calls


# ---------------------------------------------------------------------------
# Device layout
# ---------------------------------------------------------------------------

@dataclass
class VariantReindex:
    """SNP-sorted renumbering of the variant axis for the device EM space.

    Variants sharing a SNP become contiguous rows, so the per-iteration
    genotype-prob normalization runs as windowed elementwise sums instead of
    a segment-sum scatter (``ops.likelihood.probs_from_betas`` with
    ``max_per_snp``). Registry-facing results (the learnt beta addition) are
    mapped back with :meth:`unpermute_rows`; the renumbering itself is
    invisible to callers of the public API.

    Deterministic across processes: built with a stable argsort of the
    (replicated) variant→snp table only.
    """

    order: np.ndarray  # i64 [n_variants]; device row j holds registry row order[j]
    inverse: np.ndarray  # i32 [n_variants]; registry row i lives at device row inverse[i]
    variant2snp: np.ndarray  # i32 [n_variants], non-decreasing
    max_per_snp: int  # longest same-SNP run (window size for the denominators)

    @classmethod
    def build(cls, variant2snp: np.ndarray) -> "VariantReindex":
        v2s = np.asarray(variant2snp)
        order = stable_argsort(v2s)
        inverse = np.empty(len(order), dtype=np.int32)
        inverse[order] = np.arange(len(order), dtype=np.int32)
        sorted_v2s = np.ascontiguousarray(v2s[order].astype(np.int32))
        max_per_snp = int(np.bincount(sorted_v2s).max()) if len(sorted_v2s) else 1
        return cls(order=order, inverse=inverse, variant2snp=sorted_v2s, max_per_snp=max_per_snp)

    @property
    def windowed_max_per_snp(self) -> int:
        """`max_per_snp` when the windowed denominator path applies, else 0."""
        from .likelihood import MAX_WINDOWED_RUN

        return self.max_per_snp if self.max_per_snp <= MAX_WINDOWED_RUN else 0

    def remap_variant_ids(self, vid: np.ndarray) -> np.ndarray:
        """Registry variant ids → device (SNP-sorted) variant ids."""
        return self.inverse[np.asarray(vid)]

    def permute_rows(self, table: np.ndarray) -> np.ndarray:
        """Registry-ordered [n_variants, ...] rows → device order."""
        return np.ascontiguousarray(np.asarray(table)[self.order])

    def unpermute_rows(self, table: np.ndarray) -> np.ndarray:
        """Device-ordered [n_variants, ...] rows → registry order."""
        return np.ascontiguousarray(np.asarray(table)[self.inverse])

    def remap_barcode_calls(self, barcode_calls: np.recarray) -> np.recarray:
        """Copy of the call table with variant ids in device order."""
        remapped = barcode_calls.copy()
        remapped["variant_id"] = self.remap_variant_ids(
            barcode_calls["variant_id"].astype(np.int64)
        )
        return remapped


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class DeviceCalls:
    """Static-shape call arrays in the two orders the device kernels need.

    Padding rows use ``p_base_wrong = 1`` which contributes exactly zero to
    both the log-likelihood (log(p·0 + 1) = 0) and the M-step sufficient
    statistics ((post·0)^k = 0) — no masks required on device.

    Sharding layout: barcodes are partitioned into ``n_shards`` contiguous
    ranges (shard s owns barcodes [s·Bp, (s+1)·Bp)); every call lives on the
    shard owning its barcode, so the E-step segment-sum and the M-step both
    read only shard-local posteriors — the only collective per EM iteration
    is one psum of the [n_variants, n_donors] beta-addition partials. Arrays
    are flat ``[n_shards * per_shard_calls]``, ready for a
    ``PartitionSpec('barcodes')`` placement; ``cb_*`` hold LOCAL indices.
    """

    # sorted by barcode within each shard (E-step / logits order)
    cb_b: np.ndarray  # int32 [S*N], local barcode index within shard
    vid_b: np.ndarray  # int32 [S*N]
    q_b: np.ndarray  # float32 [S*N]
    # sorted by variant within each shard (M-step order)
    cb_v: np.ndarray  # int32 [S*N], local barcode index within shard
    vid_v: np.ndarray  # int32 [S*N]
    q_v: np.ndarray  # float32 [S*N]
    n_barcodes: int  # true (unpadded) barcode count
    n_barcodes_per_shard: int
    per_shard_calls: int
    n_shards: int

    @property
    def n_barcodes_padded(self) -> int:
        return self.n_barcodes_per_shard * self.n_shards


def shard_call_counts(barcode_calls, n_shards: int, barcodes_per_shard: int) -> np.ndarray:
    """Calls landing on each barcode shard ([n_shards] int64).

    Cheap pre-pass so multi-host layouts can agree on padded lengths before
    any array is built (each process counts only the calls it holds, then
    maxes across processes).
    """
    shard_of_call = barcode_calls["compressed_cb"].astype(np.int64) // barcodes_per_shard
    return np.bincount(shard_of_call, minlength=n_shards).astype(np.int64)


def device_pack_barcode_calls(
    barcode_calls: np.recarray,
    n_barcodes: int,
    n_shards: int = 1,
    pad_multiple: int = 1024,
    barcodes_per_shard: Optional[int] = None,
    shard_ids: Optional[list] = None,
    per_shard_calls_floor: int = 0,
) -> DeviceCalls:
    """Lay out collapsed barcode calls for the device kernels.

    ``shard_ids`` restricts array building to a subset of shards (arrays
    get one row block per listed shard, in order) — the multi-host path,
    where each process only holds and lays out its own barcode ranges.
    ``per_shard_calls_floor`` forces the padded per-shard length so
    processes can agree on a global static shape.
    """
    vid = barcode_calls["variant_id"].astype(np.int32)
    cb = barcode_calls["compressed_cb"].astype(np.int32)
    q = barcode_calls["p_base_wrong"].astype(np.float32)

    if len(cb):
        # fused native key sort carrying vid/q as payload (bit-identical to
        # stable_argsort + three gathers, ~3x cheaper at product scale)
        cb, vid, q = sort_calls_by_cb(cb, vid, q)
    return device_pack_columns(
        cb, vid, q, n_barcodes,
        n_shards=n_shards, pad_multiple=pad_multiple,
        barcodes_per_shard=barcodes_per_shard, shard_ids=shard_ids, per_shard_calls_floor=per_shard_calls_floor,
    )


def device_pack_columns(
    cb_sorted: np.ndarray,
    vid_sorted: np.ndarray,
    q_sorted: np.ndarray,
    n_barcodes: int,
    n_shards: int = 1,
    pad_multiple: int = 1024,
    barcodes_per_shard: Optional[int] = None,
    shard_ids: Optional[list] = None,
    per_shard_calls_floor: int = 0,
) -> DeviceCalls:
    """:func:`device_pack_barcode_calls` core over pre-barcode-sorted columns."""
    if barcodes_per_shard is None:
        barcodes_per_shard = _round_up(max(n_barcodes, n_shards), n_shards) // n_shards
    per_shard_b = barcodes_per_shard
    assert per_shard_b * n_shards >= n_barcodes
    if shard_ids is None:
        shard_ids = list(range(n_shards))

    cb = cb_sorted
    shard_of_call = cb_sorted // per_shard_b
    boundaries = np.searchsorted(shard_of_call, np.arange(n_shards + 1))
    lengths = boundaries[1:] - boundaries[:-1]
    max_len = max(1, int(lengths[shard_ids].max()) if len(cb) else 1, per_shard_calls_floor)
    max_len = _round_up(max_len, pad_multiple)

    n_blocks = len(shard_ids)
    cb_b = np.zeros((n_blocks, max_len), dtype=np.int32)
    vid_b = np.zeros((n_blocks, max_len), dtype=np.int32)
    q_b = np.ones((n_blocks, max_len), dtype=np.float32)
    cb_v = np.zeros((n_blocks, max_len), dtype=np.int32)
    vid_v = np.zeros((n_blocks, max_len), dtype=np.int32)
    q_v = np.ones((n_blocks, max_len), dtype=np.float32)
    for block, s in enumerate(shard_ids):
        lo, hi = boundaries[s], boundaries[s + 1]
        n = hi - lo
        local_cb = cb_sorted[lo:hi] - s * per_shard_b
        local_vid = vid_sorted[lo:hi]
        local_q = q_sorted[lo:hi]
        cb_b[block, :n] = local_cb
        vid_b[block, :n] = local_vid
        q_b[block, :n] = local_q
        # same shard's calls re-sorted by variant for the M-step
        vorder = stable_argsort(local_vid)
        cb_v[block, :n] = local_cb[vorder]
        vid_v[block, :n] = local_vid[vorder]
        q_v[block, :n] = local_q[vorder]

    return DeviceCalls(
        cb_b=cb_b.reshape(-1), vid_b=vid_b.reshape(-1), q_b=q_b.reshape(-1),
        cb_v=cb_v.reshape(-1), vid_v=vid_v.reshape(-1), q_v=q_v.reshape(-1),
        n_barcodes=n_barcodes,
        n_barcodes_per_shard=per_shard_b,
        per_shard_calls=max_len,
        n_shards=n_shards,
    )
