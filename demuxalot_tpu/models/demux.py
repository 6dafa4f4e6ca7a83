"""Demultiplexer: doublet-aware posterior inference and EM genotype refinement.

Orchestrates the host packing layer (``ops.packing``) and the device compute
(``ops.likelihood`` on XLA, or the fused GPU kernel in
``ops.estep_kernel``): barcode-sorted call arrays are transferred once, the
log-likelihood accumulation and EM sufficient statistics run jit-compiled on
the accelerator, and results come back as the reference-shaped pandas
dataframes (index = barcodes, columns = donors and 'A+B' doublets).

API parity with the reference namespace class (demuxalot/demux.py:24-156):
``predict_posteriors``, ``learn_genotypes``, ``staged_genotype_learning``
(a generator — the natural EM-resume hook), ``pack_calls``, plus the same
three class-level knobs. Multi-device execution is in
``demuxalot_tpu.parallel`` and uses the same underlying ops.

Regularization stance (inherited from the reference): probabilities of SNP
calls are aggregated per (variant, barcode) row rather than per molecule,
bounding the contribution of any single molecule.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..native.hostops import sort_calls_by_cb, stable_argsort
from ..ops import estep_kernel as K
from ..ops import likelihood as L
from ..ops import packing as P
from ..utils.barcodes import BarcodeHandler
from ..utils.lookup import FeatureLookup
from .genotypes import ProbabilisticGenotypes


@partial(
    jax.jit,
    static_argnames=("n_snps", "n_barcodes", "p_genotype_clip", "call_chunk", "max_per_snp"),
)
def _logits_forward(
    betas,
    variant2snp,
    mixing,
    penalties,
    vid,
    cb,
    q,
    *,
    n_snps: int,
    n_barcodes: int,
    p_genotype_clip: float,
    call_chunk: int,
    max_per_snp: int = 0,
):
    genotype_prob = L.probs_from_betas(
        betas, variant2snp, n_snps, p_genotype_clip, max_per_snp=max_per_snp
    )
    return L.barcode_logits(
        genotype_prob, mixing, penalties, vid, cb, q, n_barcodes, call_chunk=call_chunk
    )


@partial(
    jax.jit,
    static_argnames=(
        "n_snps", "n_barcodes", "p_genotype_clip", "max_per_snp", "doublets", "interpret",
    ),
)
def _kernel_logits(
    betas, variant2snp, penalties, offsets, vid, q,
    *,
    n_snps: int,
    n_barcodes: int,
    p_genotype_clip: float,
    max_per_snp: int,
    doublets: bool,
    interpret: bool,
):
    """One program: betas → genotype probs → fused E-step kernel."""
    genotype_prob = L.probs_from_betas(
        betas, variant2snp, n_snps, p_genotype_clip, max_per_snp=max_per_snp
    )
    return K.estep_logits(
        genotype_prob, penalties, offsets, vid, q,
        n_barcodes=n_barcodes, doublets=doublets, interpret=interpret,
    )


class _KernelForward:
    """E-step through the fused kernel: uploaded call runs + penalties."""

    def __init__(self, runs: dict, mixing: np.ndarray, penalties: np.ndarray,
                 interpret: bool):
        self.runs = runs
        self.doublets = K.check_mixing(mixing)
        self.penalties = jnp.asarray(penalties)
        self.interpret = interpret

    def device_arrays(self) -> list:
        return [self.runs["offsets"], self.runs["vid"], self.runs["q"], self.penalties]

    def __call__(self, betas_dev, variant2snp_dev, n_snps, p_genotype_clip, max_per_snp):
        runs = self.runs
        return _kernel_logits(
            betas_dev, variant2snp_dev, self.penalties,
            runs["offsets"], runs["vid"], runs["q"],
            n_snps=n_snps, n_barcodes=runs["n_barcodes"],
            p_genotype_clip=p_genotype_clip, max_per_snp=max_per_snp,
            doublets=self.doublets, interpret=self.interpret,
        )


@partial(
    jax.jit,
    static_argnames=("n_variants", "n_genotypes", "contribution_power", "call_chunk"),
)
def _mstep(
    posterior_probs,
    vid_v,
    cb_v,
    q_v,
    *,
    n_variants: int,
    n_genotypes: int,
    contribution_power: float,
    call_chunk: int,
):
    return L.genotype_addition_from_posteriors(
        posterior_probs, vid_v, cb_v, q_v, n_variants, n_genotypes, contribution_power,
        call_chunk=call_chunk,
    )


# Benchmark-only stage-timing hook (consumed by benchmarks/end_to_end.py).
# Set this to an empty dict before calling learn_genotypes /
# predict_posteriors and the entry point records measured per-phase wall
# seconds (host packing, layout build + upload issue, upload flush, device
# loop, result readback) into it, inserting device syncs between phases.
# None (the default) keeps the production path free of any extra syncs.
STAGE_TIMINGS: Optional[dict] = None


def _flush_device(arrays) -> int:
    """Wait for every pending op feeding ``arrays``; return their bytes."""
    dev = [a for a in arrays if isinstance(a, jax.Array)]
    jax.block_until_ready(dev)
    return int(sum(a.nbytes for a in dev))


def _stage_mark(timings: Optional[dict], key: str, t0: float) -> float:
    """Record ``key`` = now − t0 into ``timings`` (if set); return now."""
    now = time.perf_counter()
    if timings is not None:
        timings[key] = round(timings.get(key, 0.0) + (now - t0), 3)
    return now


def _materialize_logits_and_probs(logits_dev, probs_dev=None):
    """Host (logits, probs) frames; probs is the device softmax (f32)."""
    if probs_dev is None:
        probs_dev = jax.nn.softmax(logits_dev, axis=-1)
    t0 = time.perf_counter()
    logits = np.asarray(logits_dev)
    if STAGE_TIMINGS is not None:
        STAGE_TIMINGS["d2h_logits_s"] = round(time.perf_counter() - t0, 3)
        STAGE_TIMINGS["d2h_logits_bytes"] = int(logits.nbytes)
    t0 = time.perf_counter()
    probs = np.asarray(probs_dev)
    if STAGE_TIMINGS is not None:
        STAGE_TIMINGS["d2h_probs_s"] = round(time.perf_counter() - t0, 3)
        STAGE_TIMINGS["d2h_probs_bytes"] = int(probs.nbytes)
    return logits, probs


@partial(jax.jit, static_argnames=("k",))
def _compact_topk(logits, *, k: int):
    """Device-side (top-k values f32, top-k indices i32, row logsumexp f32).

    ``lax.top_k`` breaks ties toward the lowest index — the same rule as
    ``np.argmax`` on the full f32 frame, so index 0 is bit-identical to the
    host assignment.
    """
    top_vals, top_idx = jax.lax.top_k(logits, k)
    lse = jax.scipy.special.logsumexp(logits, axis=1)
    return top_vals, top_idx.astype(jnp.int32), lse.astype(jnp.float32)


@dataclass
class CompactPosteriors:
    """Link-frugal posterior result: device top-k instead of full frames.

    ``top_logits``/``top_index`` are the k best pseudogenotype logits per
    barcode (exact f32 frame entries, descending); ``logsumexp`` is the
    per-row softmax normalizer, so ``exp(top_logits - logsumexp[:, None])``
    reconstructs the exact top-k posterior probabilities without the full
    frame. ``logits_bf16`` (only when requested) is the full frame in
    bfloat16 — every entry within 1 bf16 ulp of the f32 value.
    """

    column_names: list
    barcodes: list
    top_index: np.ndarray  # [n, k] int32, descending by logit
    top_logits: np.ndarray  # [n, k] float32 (exact frame entries)
    logsumexp: np.ndarray  # [n] float32
    logits_bf16: Optional[np.ndarray]  # [n, n_pg] bfloat16, or None
    bytes_moved: int

    @property
    def assignment(self) -> np.ndarray:
        """argmax pseudogenotype index per barcode (== full-frame argmax)."""
        return self.top_index[:, 0]

    @property
    def k(self) -> int:
        return self.top_index.shape[1]

    @property
    def runner_up(self) -> np.ndarray:
        if self.k < 2:
            raise ValueError(
                "no runner-up recorded: the result holds top-1 only "
                "(k=1, or a single pseudogenotype column)"
            )
        return self.top_index[:, 1]

    @property
    def margin(self) -> np.ndarray:
        """Top-1 minus top-2 logit (f32, exact)."""
        if self.k < 2:
            raise ValueError(
                "no margin available: the result holds top-1 only "
                "(k=1, or a single pseudogenotype column)"
            )
        return self.top_logits[:, 0] - self.top_logits[:, 1]

    @property
    def top_probs(self) -> np.ndarray:
        """Posterior probability of each of the k best pseudogenotypes."""
        return np.exp(
            self.top_logits.astype(np.float64)
            - self.logsumexp.astype(np.float64)[:, None]
        ).astype(np.float32)

    @property
    def assignment_names(self) -> list:
        return [self.column_names[i] for i in self.top_index[:, 0]]

    def to_dataframe(self) -> pd.DataFrame:
        """Compact per-barcode summary frame (BARCODE-indexed).

        The runner-up/margin columns are present only when k >= 2.
        """
        columns = {"assignment": self.assignment_names}
        if self.k >= 2:
            columns["runner_up"] = [self.column_names[i] for i in self.runner_up]
            columns["logit_margin"] = self.margin
        columns["posterior"] = self.top_probs[:, 0]
        df = pd.DataFrame(columns, index=list(self.barcodes))
        df.index.name = "BARCODE"
        return df

    def logits_dataframe(self) -> pd.DataFrame:
        """Full logits frame upcast from bfloat16 (requires include_logits)."""
        if self.logits_bf16 is None:
            raise ValueError(
                "full logits were not requested; pass include_logits=True to "
                "predict_posteriors_compact"
            )
        df = pd.DataFrame(
            data=self.logits_bf16.astype(np.float32),
            index=list(self.barcodes),
            columns=self.column_names,
        )
        df.index.name = "BARCODE"
        return df


def ensure_packed(chromosome2compressed_snp_calls, genotypes) -> "PackedCalls":
    """Route any calls input through one PackedCalls (transient for dicts).

    The single packing/layout code path both engines share: pack-once
    datasets pass through untouched, raw per-chromosome call dicts get a
    transient pack — bit-identical results either way (pinned by tests).
    """
    if isinstance(chromosome2compressed_snp_calls, PackedCalls):
        return chromosome2compressed_snp_calls
    return PackedCalls(chromosome2compressed_snp_calls, genotypes)


def _validate_topk(k, n_columns: int) -> int:
    """Clamp k into [1, n_columns]; reject non-positive requests early."""
    if int(k) < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return int(min(int(k), n_columns))


def _build_compact_result(
    column_names, barcodes, top_logits_full, top_index_full, logsumexp_full,
    logits_bf16_full, n_barcodes: int, timings: Optional[dict],
) -> "CompactPosteriors":
    """Host-side CompactPosteriors assembly shared by both engines.

    The ``*_full`` arrays are the as-transferred host arrays — possibly
    padded past ``n_barcodes`` on sharded meshes — so ``bytes_moved``
    counts the actual link traffic; rows are sliced to the real barcodes.
    """
    bytes_moved = int(
        top_logits_full.nbytes + top_index_full.nbytes + logsumexp_full.nbytes
        + (logits_bf16_full.nbytes if logits_bf16_full is not None else 0)
    )
    if timings is not None:
        timings["d2h_compact_bytes"] = bytes_moved
    return CompactPosteriors(
        column_names=list(column_names),
        barcodes=list(barcodes),
        top_index=top_index_full[:n_barcodes],
        top_logits=top_logits_full[:n_barcodes],
        logsumexp=logsumexp_full[:n_barcodes],
        logits_bf16=(
            logits_bf16_full[:n_barcodes] if logits_bf16_full is not None else None
        ),
        bytes_moved=bytes_moved,
    )


def auto_damping_select(learn_with, n_genotypes: int):
    """Shared damping="auto" selector (single-device and sharded engines).

    ``learn_with(damping)`` runs the engine's learn_genotypes and returns
    ``(learnt_genotypes, probs_df)``. See
    :meth:`Demultiplexer._learn_genotypes_auto_damped` for the measured
    rationale behind the disagreement statistic.
    """
    learnt_plain, probs_plain = learn_with(None)
    learnt_anchor, probs_anchor = learn_with("anchor")
    singlets_plain = probs_plain.values[:, :n_genotypes]
    assign_plain = singlets_plain.argmax(axis=1)
    assign_anchor = probs_anchor.values[:, :n_genotypes].argmax(axis=1)
    confident = singlets_plain.max(axis=1) >= Demultiplexer.auto_damping_confidence
    differs = assign_plain != assign_anchor
    disagreement = float(
        differs[confident].mean() if confident.any() else differs.mean()
    )
    anchored = disagreement > Demultiplexer.auto_damping_disagreement_threshold
    learnt, probs = (
        (learnt_anchor, probs_anchor) if anchored else (learnt_plain, probs_plain)
    )
    probs.attrs["damping_selected"] = "anchor" if anchored else None
    probs.attrs["anchored_disagreement"] = disagreement
    return learnt, probs


class _SnpAggregationLayout:
    """Device-resident (barcode, snp) grouping for the aggregate_on_snps path.

    The grouping (FeatureLookup + stable sort by group) depends only on the
    molecule calls — not on the evolving genotype state — so an EM loop must
    build it exactly once and reuse it every iteration (the reference pays
    the regrouping per call of _compute_barcode_logits,
    demuxalot/demux.py:204-220; here the rebuild cost would dominate the
    device math at scale). All operands are uploaded as jnp arrays at build
    time, already sorted by group id.
    """

    __slots__ = (
        "vid_by_group", "q_by_group", "group_of_call",
        "barcode_of_group", "calls_per_group", "n_groups",
    )

    def __init__(self, vid_by_group, q_by_group, group_of_call,
                 barcode_of_group, calls_per_group, n_groups):
        self.vid_by_group = vid_by_group
        self.q_by_group = q_by_group
        self.group_of_call = group_of_call
        self.barcode_of_group = barcode_of_group
        self.calls_per_group = calls_per_group
        self.n_groups = n_groups

    @classmethod
    def build(cls, molecule_calls: P.MoleculeCalls) -> "_SnpAggregationLayout":
        snp_ids = molecule_calls.snp_id
        groups = FeatureLookup(molecule_calls.compressed_cb, snp_ids)
        group_of_call, calls_per_group = groups.compress(
            molecule_calls.compressed_cb, snp_ids
        )
        barcode_of_group, _snp_of_group = groups.lookup_for_individual_features()
        by_group = stable_argsort(group_of_call)
        return cls(
            vid_by_group=jnp.asarray(molecule_calls.variant_id[by_group]),
            q_by_group=jnp.asarray(molecule_calls.p_base_wrong[by_group]),
            group_of_call=jnp.asarray(group_of_call[by_group].astype(np.int32)),
            barcode_of_group=jnp.asarray(barcode_of_group.astype(np.int32)),
            calls_per_group=jnp.asarray(calls_per_group.astype(np.float32)),
            n_groups=groups.nvalues,
        )


class PackedCalls:
    """Pack once, run many: packed call tables plus a device-layout cache.

    Every entry point repeats the same expensive host stages per call — the
    calls↔variants join (reference analogue: demuxalot/demux.py:342-347),
    the (variant, barcode) collapse, the SNP-sorted variant reindex, the
    kernel's call runs, and the device upload of the call tables — yet all
    of them depend only on (calls, the genotype registry's variant KEYS,
    n_barcodes), never on beta values or the doublet prior. The standard
    product flow pays them twice (``learn_genotypes``, then
    ``predict_posteriors`` on the learnt clone) and ``damping="auto"`` two
    more times. Build a :class:`PackedCalls` once and pass it anywhere
    ``chromosome2compressed_snp_calls`` is accepted::

        packed = Demultiplexer.pack_dataset(calls, genotypes)
        learnt, probs_em = Demultiplexer.learn_genotypes(packed, genotypes, handler)
        logits, probs = Demultiplexer.predict_posteriors(packed, learnt, handler)

    Genotype objects passed alongside a ``PackedCalls`` may differ in beta
    VALUES (e.g. the learnt clone — betas regularization is recomputed per
    use, it is cheap) but must carry the same variant registry; this is
    verified with array compares on every use. The multi-device engine
    (``parallel.sharded``) caches its shard-aware layouts here too
    (``_sharded_layouts``), so sharded learn/predict on one dataset also
    re-lay out nothing.
    """

    def __init__(self, chromosome2compressed_snp_calls, genotypes: ProbabilisticGenotypes):
        self.variant2snp = genotypes.get_snp_ids_for_variants()
        self.molecule_calls = P.match_calls_to_variants(
            chromosome2compressed_snp_calls, genotypes
        )
        names, chrom_slots, positions, base_chars, base_slots = genotypes.variant_columns()
        self._registry_key = (
            tuple(names),
            np.array(chrom_slots, copy=True),
            np.array(positions, copy=True),
            tuple(base_chars),
            np.array(base_slots, copy=True),
        )
        self.reindex = P.VariantReindex.build(self.variant2snp)
        # SoA engine path: one fused collapse straight into device variant
        # order — (vid, cb)-sorted, so the M-step layout needs no sort and
        # the E-step layout exactly one. The reference-shaped AoS recarray
        # (registry order) is only built if someone asks (.barcode_calls).
        self.calls_v = P.collapse_device_order(self.molecule_calls, self.reindex)
        self._calls_b: Optional[tuple] = None
        self._barcode_calls: Optional[np.recarray] = None
        self._remapped: Optional[np.recarray] = None
        self._call_runs: dict = {}
        self._device_flat: dict = {}
        # multi-device engine's shard layouts (parallel/sharded.py) — cached
        # here so learn/predict on the same dataset never re-tile
        self._sharded_layouts: dict = {}

    @property
    def barcode_calls(self) -> np.recarray:
        """Reference-shaped collapsed call recarray (registry variant order).

        Lazy: the engine entry points run on the SoA columns (``calls_v`` /
        ``calls_by_barcode``); this materializes only for API users of the
        reference 4-tuple (``Demultiplexer.pack_calls``).
        """
        if self._barcode_calls is None:
            self._barcode_calls = P.molecule_calls_to_barcode_calls(self.molecule_calls)
        return self._barcode_calls

    def calls_by_barcode(self) -> tuple:
        """(cb, vid, q) columns in barcode-major order (cached one-sort view)."""
        if self._calls_b is None:
            self._calls_b = self.calls_v.by_barcode()
        return self._calls_b

    @property
    def n_variants(self) -> int:
        return len(self.variant2snp)

    def verify_registry(self, genotypes: ProbabilisticGenotypes) -> None:
        """Raise if ``genotypes`` carries a different variant registry."""
        names, chrom_slots, positions, base_chars, base_slots = genotypes.variant_columns()
        ok = (
            tuple(names) == self._registry_key[0]
            and np.array_equal(chrom_slots, self._registry_key[1])
            and np.array_equal(positions, self._registry_key[2])
            and tuple(base_chars) == self._registry_key[3]
            and np.array_equal(base_slots, self._registry_key[4])
        )
        if not ok:
            raise ValueError(
                "PackedCalls was built against a different variant registry; "
                "beta values may change between uses (e.g. the learnt clone) "
                "but variants may not — re-pack with Demultiplexer.pack_dataset"
            )

    def betas_for(self, genotypes: ProbabilisticGenotypes, add_data_prior: bool) -> np.ndarray:
        """Regularized prior betas for THIS genotypes object (recomputed, cheap)."""
        self.verify_registry(genotypes)
        return P.compute_prior_betas(
            genotypes, self.molecule_calls, self.variant2snp, add_data_prior=add_data_prior
        )

    def remapped_barcode_calls(self) -> np.recarray:
        """Call table with variant ids in SNP-sorted device order (cached)."""
        if self._remapped is None:
            self._remapped = self.reindex.remap_barcode_calls(self.barcode_calls)
        return self._remapped

    def call_runs(self, n_barcodes: int) -> dict:
        """Cached device-resident E-step kernel layout (``ops.estep_kernel``).

        The barcode-sorted call stream plus per-barcode run offsets,
        uploaded once per ``n_barcodes``: it depends only on the calls,
        never on the doublet prior, so learn(doublet_prior=0) and
        predict(0.35) share one build and one upload. Cached buffers stay
        on the device for the life of this PackedCalls (see :meth:`clear`).
        """
        runs = self._call_runs.get(n_barcodes)
        if runs is None:
            host = K.CallRuns.build(*self.calls_by_barcode(), n_barcodes)
            runs = {
                "offsets": jnp.asarray(host.offsets),
                "vid": jnp.asarray(host.vid),
                "q": jnp.asarray(host.q),
                "n_barcodes": host.n_barcodes,
            }
            self._call_runs[n_barcodes] = runs
        return runs

    def clear(self) -> None:
        """Drop every cached layout (frees their pinned device buffers).

        The pack itself (host call tables, registry key) survives; the next
        entry point rebuilds layouts on demand.
        """
        self._call_runs.clear()
        self._device_flat.clear()
        self._sharded_layouts.clear()
        self._remapped = None
        self._calls_b = None
        self._barcode_calls = None

    def device_flat(self, n_barcodes: int):
        """Cached device-resident flat dual-sort layout (XLA E-step, M-step).

        Returns ``(vid_b, cb_b, q_b, vid_v, cb_v, q_v)`` jnp arrays.
        """
        arrays = self._device_flat.get(n_barcodes)
        if arrays is None:
            cb_s, vid_s, q_s = self.calls_by_barcode()
            device = P.device_pack_columns(cb_s, vid_s, q_s, n_barcodes)
            arrays = tuple(
                jnp.asarray(x)
                for x in (device.vid_b, device.cb_b, device.q_b,
                          device.vid_v, device.cb_v, device.q_v)
            )
            self._device_flat[n_barcodes] = arrays
        return arrays


class _EMRun:
    """Device-resident EM loop state shared by the learning entry points.

    ``device_iterations`` yields per-iteration device arrays only;
    ``materialize`` converts one yielded state into the reference-shaped
    (posterior df, debug dict). Splitting the two lets ``learn_genotypes``
    transfer exactly one iteration to the host while
    ``staged_genotype_learning`` keeps the reference's per-iteration
    generator semantics (demuxalot/demux.py:68-118) unchanged.
    """

    def __init__(
        self,
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        n_iterations: int,
        p_genotype_clip: float,
        doublet_prior: float,
        barcode_prior_logits: Optional[np.ndarray],
        damping: Optional[str] = None,
    ):
        assert 0 <= doublet_prior < 1
        if damping not in (None, "anchor"):
            raise ValueError(
                f"damping must be None or 'anchor', got {damping!r}"
                + (" ('auto' is only available through learn_genotypes, which"
                   " needs the whole trajectory to decide)" if damping == "auto" else "")
            )
        self.damping = damping
        self.mixing, self.column_names = L.pseudogenotype_mixing(
            genotypes.genotype_names, doublet_prior
        )
        self.penalties = L.doublet_penalties(genotypes.n_genotypes, doublet_prior)
        if barcode_prior_logits is not None:
            n_options = len(self.penalties)
            assert barcode_prior_logits.shape == (
                barcode_handler.n_barcodes,
                n_options,
            ), "wrong shape of priors"

        timings = STAGE_TIMINGS
        t_mark = time.perf_counter()
        # every flow routes through one PackedCalls (a transient one for raw
        # call dicts): a single packing/layout code path, so the pack-once
        # engine is bit-identical to the per-call entry points by construction
        packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
        variant2snp = packed.variant2snp
        prior_betas = packed.betas_for(genotypes, add_data_prior=True)
        molecule_calls = packed.molecule_calls
        t_mark = _stage_mark(timings, "pack_s", t_mark)
        self.prior_betas = prior_betas
        self.barcode_handler = barcode_handler
        self.n_iterations = n_iterations
        self.p_genotype_clip = p_genotype_clip
        self.n_variants, self.n_genotypes = prior_betas.shape
        self.n_snps = int(variant2snp.max()) + 1 if self.n_variants else 0
        n_barcodes = barcode_handler.n_barcodes
        self.n_barcodes = n_barcodes

        # device EM space uses SNP-sorted variant rows (windowed genotype-prob
        # denominators); results are mapped back to registry order at yield
        self.reindex = packed.reindex
        self.max_per_snp = self.reindex.windowed_max_per_snp
        self.molecule_calls = molecule_calls
        self.snp_aggregation_layout = None
        if Demultiplexer.aggregate_on_snps:
            from dataclasses import replace as _dc_replace

            self.molecule_calls = _dc_replace(
                molecule_calls,
                variant_id=self.reindex.remap_variant_ids(molecule_calls.variant_id),
            )
            # grouping is independent of the EM state: build once, reuse
            # across every iteration (O(1) host work per iteration)
            self.snp_aggregation_layout = _SnpAggregationLayout.build(self.molecule_calls)
        self.variant2snp_dev = jnp.asarray(self.reindex.variant2snp)

        self.kernel_forward = None
        if not Demultiplexer.aggregate_on_snps:
            use_kernel, interpret = K.resolve_use_pallas(Demultiplexer.use_pallas)
            if use_kernel:
                self.kernel_forward = _KernelForward(
                    packed.call_runs(n_barcodes), self.mixing, self.penalties,
                    interpret,
                )
            else:
                self.mixing_dev = jnp.asarray(self.mixing)
                self.penalties_dev = jnp.asarray(self.penalties)
        # flat dual-sort layout: barcode order feeds the XLA E-step,
        # variant order the M-step
        (self.vid_b, self.cb_b, self.q_b,
         self.vid_v, self.cb_v, self.q_v) = packed.device_flat(n_barcodes)
        self.prior_betas_dev = jnp.asarray(self.reindex.permute_rows(prior_betas))

        # damping="anchor": M-step additions apply only at variants whose
        # GENOTYPE prior carries information (nonzero betas before the data
        # prior). Measured (QUALITY.json damped row): the unsupervised
        # divergence at heavy degradation lives entirely in the prior-less
        # variants — their additions are unidentifiable and run away, while
        # prior-anchored updates refine monotonically.
        self.anchor_mask_dev = None
        if damping == "anchor":
            registry_mask = (
                np.asarray(genotypes.get_betas()).sum(axis=1) > 0
            ).astype(np.float32)
            device_mask = registry_mask[self.reindex.order]
            self.anchor_mask_dev = jnp.asarray(device_mask[:, None])
        self.prior_logits_dev = (
            jnp.asarray(barcode_prior_logits) if barcode_prior_logits is not None else None
        )
        t_mark = _stage_mark(timings, "layout_s", t_mark)
        if timings is not None:
            # flush every issued upload so layout_s (host layout + upload
            # issue) and upload_flush_s (transfer backlog) split cleanly
            arrays = [self.prior_betas_dev, self.variant2snp_dev,
                      self.anchor_mask_dev, self.prior_logits_dev]
            if self.kernel_forward is not None:
                arrays += self.kernel_forward.device_arrays()
            for name in ("vid_b", "cb_b", "q_b", "vid_v", "cb_v", "q_v",
                         "mixing_dev", "penalties_dev"):
                arrays.append(getattr(self, name, None))
            timings["h2d_bytes"] = _flush_device(arrays)
            _stage_mark(timings, "upload_flush_s", t_mark)

    def device_iterations(self):
        """Yield (probs_dev, logits_dev, addition_dev) per EM iteration.

        ``addition_dev`` is the state *entering* the iteration (the last
        iteration performs no M-step), in the SNP-sorted device row order.
        """
        genotype_addition_dev = jnp.zeros_like(self.prior_betas_dev)
        for _iteration in range(self.n_iterations):
            is_last = _iteration == self.n_iterations - 1
            if Demultiplexer.aggregate_on_snps:
                genotype_prob = np.asarray(
                    L.probs_from_betas(
                        self.prior_betas_dev + genotype_addition_dev,
                        self.variant2snp_dev, self.n_snps,
                        self.p_genotype_clip, max_per_snp=self.max_per_snp,
                    )
                )
                logits_dev = jnp.asarray(
                    Demultiplexer._compute_logits_aggregating_on_snps(
                        genotype_prob, self.mixing, self.penalties,
                        self.molecule_calls, self.n_barcodes,
                        layout=self.snp_aggregation_layout,
                    )
                )
            elif self.kernel_forward is not None:
                logits_dev = self.kernel_forward(
                    self.prior_betas_dev + genotype_addition_dev,
                    self.variant2snp_dev, self.n_snps,
                    self.p_genotype_clip, self.max_per_snp,
                )
            else:
                logits_dev = _logits_forward(
                    self.prior_betas_dev + genotype_addition_dev,
                    self.variant2snp_dev, self.mixing_dev, self.penalties_dev,
                    self.vid_b, self.cb_b, self.q_b,
                    n_snps=self.n_snps, n_barcodes=self.n_barcodes,
                    p_genotype_clip=self.p_genotype_clip,
                    call_chunk=Demultiplexer.call_chunk,
                    max_per_snp=self.max_per_snp,
                )
            if _iteration == 0 and self.prior_logits_dev is not None:
                assert self.prior_logits_dev.shape == logits_dev.shape, (
                    "mismatching priors passed"
                )
                logits_dev = logits_dev + self.prior_logits_dev

            probs_dev = jax.nn.softmax(logits_dev, axis=-1)
            yield probs_dev, logits_dev, genotype_addition_dev
            if is_last:
                continue

            genotype_addition_dev = _mstep(
                probs_dev,
                self.vid_v, self.cb_v, self.q_v,
                n_variants=self.n_variants, n_genotypes=self.n_genotypes,
                contribution_power=float(Demultiplexer.contribution_power),
                call_chunk=Demultiplexer.call_chunk,
            )
            if self.anchor_mask_dev is not None:
                genotype_addition_dev = genotype_addition_dev * self.anchor_mask_dev

    def materialize(self, state) -> Tuple[pd.DataFrame, dict]:
        """One device state → (posterior probs df, debug dict) on the host."""
        probs_dev, logits_dev, addition_dev = state
        logits_np, probs_np = _materialize_logits_and_probs(logits_dev, probs_dev)
        barcode_posterior_probs_df = pd.DataFrame(
            data=probs_np,
            index=self.barcode_handler.ordered_barcodes,
            columns=self.column_names,
        )
        t0 = time.perf_counter()
        addition = np.asarray(addition_dev)
        if STAGE_TIMINGS is not None:
            STAGE_TIMINGS["d2h_addition_s"] = round(time.perf_counter() - t0, 3)
            STAGE_TIMINGS["d2h_addition_bytes"] = int(addition.nbytes)
        debug_information = {
            "barcode_logits": logits_np,
            "genotype_prior": self.prior_betas,
            "genotype_addition": self.reindex.unpermute_rows(addition),
        }
        return barcode_posterior_probs_df, debug_information


_snp_aggregated_logits_jit = partial(
    jax.jit,
    static_argnames=("n_groups", "n_barcodes", "compensation", "p_bad_snp", "call_chunk"),
)(L.snp_aggregated_logits)


class Demultiplexer:
    """Demultiplexer that can also learn (refine) genotypes from the data."""

    # contribution_power dampens contributions from barcodes that have no
    # clearly-best candidate donor
    contribution_power = 2.0
    aggregate_on_snps = False
    compensation_during_computing_barcode_logits = 0.5
    # device knobs (framework-specific): calls per XLA scan chunk, and the
    # fused E-step kernel: None = on a GPU (XLA elsewhere), True = required
    # (raises where it cannot compile), False = XLA, "interpret" = the
    # kernel in the Pallas interpreter (tests)
    call_chunk = L.DEFAULT_CALL_CHUNK
    use_pallas: Union[None, bool, str] = None

    # -- public API --------------------------------------------------------
    @staticmethod
    def learn_genotypes(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        n_iterations: int = 5,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.0,
        barcode_prior_logits: Optional[np.ndarray] = None,
        damping: Optional[str] = None,
    ) -> Tuple[ProbabilisticGenotypes, pd.DataFrame]:
        """EM-refine genotypes from data, starting from an initial guess.

        :param chromosome2compressed_snp_calls: output of count_snps
        :param genotypes: initial genotypes (e.g. from a bead array or WGS)
        :param barcode_handler: which barcodes to consider
        :param n_iterations: number of EM iterations
        :param p_genotype_clip: minimal probability assigned to a polymorphism
        :param doublet_prior: prior fraction of doublets; zero skips doublet
            columns entirely (helpful with many donors)
        :param barcode_prior_logits: optional [n_barcodes, n_options] prior
            assignment logits, applied at the first iteration only
        :param damping: None (default, reference-parity EM), "anchor", or
            "auto". "anchor" restricts M-step updates to variants whose
            genotype prior is informative (nonzero betas): anchored EM
            cannot diverge in the heavily-degraded unsupervised regime where
            the default (and the reference, identically) does; the cost is
            that prior-less variants are never refined, which loses to plain
            EM whenever plain EM converges. "auto" resolves that trade-off
            from the data: it runs both and measures where they disagree.
            The divergence mode is barcodes driven into *confidently wrong*
            clusters, and the anchored run — whose donor identities cannot
            drift — is the truth-free witness: among barcodes plain EM
            assigns with max singlet posterior ≥ 0.9, disagreement with the
            anchored assignment stays ≤ ~5% in every measured converging
            run (including where plain EM beats anchored) and jumps to
            24–39% in every diverging one. Above 15% "auto" returns the
            anchored result, otherwise the plain one — measured
            ``loss_after_auto_em`` ≤ min(prior-only, plain EM) at every
            QUALITY.json sweep point. Costs two EM runs.
        :return: (learnt genotypes, last-iteration barcode posterior probs)
        """
        if damping == "auto":
            return Demultiplexer._learn_genotypes_auto_damped(
                chromosome2compressed_snp_calls, genotypes, barcode_handler,
                n_iterations, p_genotype_clip, doublet_prior, barcode_prior_logits,
            )
        # device-resident loop: unlike the staged generator, only the LAST
        # iteration's posteriors/addition ever cross to the host
        run = _EMRun(
            chromosome2compressed_snp_calls, genotypes, barcode_handler,
            n_iterations, p_genotype_clip, doublet_prior, barcode_prior_logits,
            damping=damping,
        )
        timings = STAGE_TIMINGS
        t_mark = time.perf_counter()
        state = None
        for state in run.device_iterations():
            pass
        assert state is not None, "n_iterations must be >= 1"
        if timings is not None:
            _flush_device(list(state))
        t_mark = _stage_mark(timings, "device_loop_s", t_mark)
        last_iteration_barcode_probs, debug_information = run.materialize(state)
        _stage_mark(timings, "materialize_s", t_mark)
        learnt_genotypes = genotypes._with_betas(
            genotypes.get_betas() + debug_information["genotype_addition"]
        )
        return learnt_genotypes, last_iteration_barcode_probs

    # disagreement (plain vs anchored argmax, among plain-confident barcodes)
    # above this fraction = plain EM diverged. Measured margins at the quality
    # sweep, two independent degradation masks each (tests/
    # test_reference_scale.py): every converging run ≤ 0.052 — including the
    # one where plain EM BEATS anchored — every diverging run ≥ 0.239.
    auto_damping_disagreement_threshold = 0.15
    auto_damping_confidence = 0.9

    @staticmethod
    def _learn_genotypes_auto_damped(
        chromosome2compressed_snp_calls, genotypes, barcode_handler,
        n_iterations, p_genotype_clip, doublet_prior, barcode_prior_logits,
    ):
        """damping="auto": plain EM unless the anchored run refutes it.

        Donor *identity* comes solely from the prior; the anchored M-step
        (updates gated to prior-informed variants) cannot lose it, so it
        serves as a truth-free witness. Plain-EM divergence manifests as
        barcodes assigned confidently AND differently from the anchored
        result — measured flat ~3% in converging regimes, 24–39% in
        diverging ones (docs/DESIGN.md §9). Drift metrics against
        iteration-0 posteriors were measured useless here (~1–3%
        everywhere): the divergence does not flip the prior-confident
        barcodes, it invents confident clusters among the unconfident rest.
        """
        common = dict(
            n_iterations=n_iterations, p_genotype_clip=p_genotype_clip,
            doublet_prior=doublet_prior,
            barcode_prior_logits=barcode_prior_logits,
        )
        # the plain and anchored runs share every layout and upload: pack once
        chromosome2compressed_snp_calls = ensure_packed(
            chromosome2compressed_snp_calls, genotypes
        )

        def learn_with(damping):
            return Demultiplexer.learn_genotypes(
                chromosome2compressed_snp_calls, genotypes, barcode_handler,
                damping=damping, **common,
            )

        return auto_damping_select(learn_with, genotypes.n_genotypes)

    @staticmethod
    def staged_genotype_learning(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        n_iterations: int = 5,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.0,
        barcode_prior_logits: Optional[np.ndarray] = None,
        damping: Optional[str] = None,
    ):
        """Generator EM loop; yields (posterior probs df, debug info) per iteration.

        The prior betas stay frozen; learning accumulates into a separate
        additive term (``genotype_addition``), and only singlet posterior
        columns drive the M-step (reference: demuxalot/demux.py:68-118).
        ``damping`` as in :meth:`learn_genotypes`.
        """
        run = _EMRun(
            chromosome2compressed_snp_calls, genotypes, barcode_handler,
            n_iterations, p_genotype_clip, doublet_prior, barcode_prior_logits,
            damping=damping,
        )
        for state in run.device_iterations():
            # yielding here provides aligned posteriors for genotypes and barcodes
            yield run.materialize(state)

    @staticmethod
    def predict_posteriors(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.35,
    ) -> Tuple[pd.DataFrame, pd.DataFrame]:
        """Posterior donor assignment for every barcode (no learning).

        Returns (logits_df, probs_df), both indexed by 'BARCODE' with columns
        = donors plus 'DonorA+DonorB' doublets.
        """
        timings = STAGE_TIMINGS
        logits_dev, column_names = Demultiplexer._predict_logits_dev(
            chromosome2compressed_snp_calls, genotypes, barcode_handler,
            p_genotype_clip, doublet_prior, timings,
        )
        t_mark = time.perf_counter()
        barcode_posterior_logits, probs = _materialize_logits_and_probs(logits_dev)
        _stage_mark(timings, "materialize_s", t_mark)
        logits_df = pd.DataFrame(
            data=barcode_posterior_logits,
            index=list(barcode_handler.ordered_barcodes),
            columns=column_names,
        )
        logits_df.index.name = "BARCODE"
        probs_df = pd.DataFrame(
            data=probs, index=list(barcode_handler.ordered_barcodes), columns=column_names
        )
        probs_df.index.name = "BARCODE"
        return logits_df, probs_df

    @staticmethod
    def predict_posteriors_compact(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        p_genotype_clip: float = 0.01,
        doublet_prior: float = 0.35,
        k: int = 4,
        include_logits: bool = False,
    ) -> "CompactPosteriors":
        """Link-frugal posterior inference: device-side top-k readback.

        Same forward as :meth:`predict_posteriors` (which keeps the full
        f32 dataframe contract and stays the default API), but instead of
        pulling the full ``[n_barcodes, n_pseudogenotypes]`` f32 logits
        frame to the host, the top-``k`` logits/indices and the per-row
        log-sum-exp are computed on device and only those move — ~(8k+4)
        bytes per barcode instead of 4*n_pg. Assignments are bit-identical
        to ``argmax`` over the full f32 frame (same values, same
        lowest-index tie-breaking) and the returned top-k logits are the
        exact f32 frame entries. ``include_logits=True`` additionally
        returns the full frame as bfloat16 (|delta| <= 1 bf16 ulp of the
        f32 values, half the bytes).

        The reference has no analogue (it always materializes both full
        frames, demuxalot/demux.py:120-156); this exists because posterior
        readback is pure link cost at product scale (277 MB at 131k
        barcodes x 528 pseudogenotypes).
        """
        timings = STAGE_TIMINGS
        logits_dev, column_names = Demultiplexer._predict_logits_dev(
            chromosome2compressed_snp_calls, genotypes, barcode_handler,
            p_genotype_clip, doublet_prior, timings,
        )
        k = _validate_topk(k, len(column_names))
        top_vals_dev, top_idx_dev, lse_dev = _compact_topk(logits_dev, k=k)
        logits_bf16_dev = (
            logits_dev.astype(jnp.bfloat16) if include_logits else None
        )
        t_mark = time.perf_counter()
        result = _build_compact_result(
            column_names, barcode_handler.ordered_barcodes,
            np.asarray(top_vals_dev), np.asarray(top_idx_dev),
            np.asarray(lse_dev),
            np.asarray(logits_bf16_dev) if logits_bf16_dev is not None else None,
            barcode_handler.n_barcodes, timings,
        )
        _stage_mark(timings, "materialize_s", t_mark)
        return result

    @staticmethod
    def _predict_logits_dev(
        chromosome2compressed_snp_calls,
        genotypes: ProbabilisticGenotypes,
        barcode_handler: BarcodeHandler,
        p_genotype_clip: float,
        doublet_prior: float,
        timings: Optional[dict],
    ):
        """Device logits [n_barcodes, n_pg] + column names (shared forward)."""
        mixing, column_names = L.pseudogenotype_mixing(genotypes.genotype_names, doublet_prior)
        penalties = L.doublet_penalties(genotypes.n_genotypes, doublet_prior)

        t_mark = time.perf_counter()
        # single packing/layout path: raw call dicts get a transient
        # PackedCalls (see _EMRun — bit-identity with the pack-once engine)
        packed = ensure_packed(chromosome2compressed_snp_calls, genotypes)
        variant2snp = packed.variant2snp
        prior_betas = packed.betas_for(genotypes, add_data_prior=False)
        molecule_calls = packed.molecule_calls
        t_mark = _stage_mark(timings, "pack_s", t_mark)
        n_variants = prior_betas.shape[0]
        n_snps = int(variant2snp.max()) + 1 if n_variants else 0
        n_barcodes = barcode_handler.n_barcodes

        # SNP-sorted device variant space (see staged_genotype_learning);
        # logits are invariant to the renumbering, so nothing maps back
        reindex = packed.reindex
        max_per_snp = reindex.windowed_max_per_snp
        prior_betas_sorted = reindex.permute_rows(prior_betas)
        v2s_sorted = reindex.variant2snp

        use_kernel, interpret = K.resolve_use_pallas(Demultiplexer.use_pallas)
        if Demultiplexer.aggregate_on_snps:
            from dataclasses import replace as _dc_replace

            molecule_calls = _dc_replace(
                molecule_calls,
                variant_id=reindex.remap_variant_ids(molecule_calls.variant_id),
            )
            genotype_prob = np.asarray(
                L.probs_from_betas(
                    jnp.asarray(prior_betas_sorted), jnp.asarray(v2s_sorted),
                    n_snps, p_genotype_clip, max_per_snp=max_per_snp,
                )
            )
            assert np.isfinite(genotype_prob).all()
            logits_dev = jnp.asarray(
                Demultiplexer._compute_logits_aggregating_on_snps(
                    genotype_prob, mixing, penalties, molecule_calls, n_barcodes
                )
            )
        elif use_kernel:
            forward = _KernelForward(
                packed.call_runs(n_barcodes), mixing, penalties, interpret
            )
            betas_dev = jnp.asarray(prior_betas_sorted)
            v2s_dev = jnp.asarray(v2s_sorted)
            t_mark = _stage_mark(timings, "layout_s", t_mark)
            if timings is not None:
                timings["h2d_bytes"] = _flush_device(
                    [betas_dev, v2s_dev, *forward.device_arrays()]
                )
                t_mark = _stage_mark(timings, "upload_flush_s", t_mark)
            logits_dev = forward(betas_dev, v2s_dev, n_snps, p_genotype_clip, max_per_snp)
        else:
            vid_b, cb_b, q_b = packed.device_flat(n_barcodes)[:3]
            logits_dev = _logits_forward(
                jnp.asarray(prior_betas_sorted),
                jnp.asarray(v2s_sorted),
                jnp.asarray(mixing),
                jnp.asarray(penalties),
                vid_b,
                cb_b,
                q_b,
                n_snps=n_snps,
                n_barcodes=n_barcodes,
                p_genotype_clip=p_genotype_clip,
                call_chunk=Demultiplexer.call_chunk,
                max_per_snp=max_per_snp,
            )

        if timings is not None:
            _flush_device([logits_dev])
        _stage_mark(timings, "forward_s", t_mark)
        return logits_dev, column_names

    # -- internals ---------------------------------------------------------
    @staticmethod
    def pack_calls(chromosome2compressed_snp_calls, genotypes, add_data_prior: bool):
        if isinstance(chromosome2compressed_snp_calls, PackedCalls):
            packed = chromosome2compressed_snp_calls
            return (
                packed.variant2snp,
                packed.betas_for(genotypes, add_data_prior),
                packed.molecule_calls,
                packed.barcode_calls,
            )
        return P.pack_calls(chromosome2compressed_snp_calls, genotypes, add_data_prior)

    @staticmethod
    def pack_dataset(chromosome2compressed_snp_calls, genotypes) -> PackedCalls:
        """Pack once for reuse across entry points (see :class:`PackedCalls`)."""
        return PackedCalls(chromosome2compressed_snp_calls, genotypes)

    # parity aliases for the reference's helper names
    @staticmethod
    def _doublet_penalties(n_genotypes: int, doublet_prior: float) -> np.ndarray:
        return L.doublet_penalties(n_genotypes, doublet_prior)

    @staticmethod
    def molecule_calls2barcode_calls(molecule_calls):
        return P.molecule_calls_to_barcode_calls(molecule_calls)

    @staticmethod
    def _compute_probs_from_betas(variant_index2snp_index, variant_index2betas, p_genotype_clip):
        """Per-donor variant probabilities (host numpy parity helper)."""
        n_snps = int(np.max(variant_index2snp_index)) + 1 if len(variant_index2snp_index) else 0
        return np.asarray(
            L.probs_from_betas(
                jnp.asarray(variant_index2betas),
                jnp.asarray(np.asarray(variant_index2snp_index, dtype=np.int32)),
                n_snps,
                p_genotype_clip,
            )
        )

    @staticmethod
    def _iterate_genotypes_options(genotype_names, genotype_prob: np.ndarray, doublet_prior: float):
        """Yield (pseudogenotype index, name, per-variant prob) incl. doublets."""
        mixing, names = L.pseudogenotype_mixing(list(genotype_names), doublet_prior)
        expanded = genotype_prob @ mixing
        for pg_index, name in enumerate(names):
            yield pg_index, name, expanded[:, pg_index]

    @staticmethod
    def compute_barcode_logits(
        genotype_names, barcode_calls, molecule_calls, doublet_prior: float,
        genotype_prob: np.ndarray, n_barcodes: int, n_genotypes: int,
    ):
        """(logits, column names); dispatches on ``aggregate_on_snps``."""
        mixing, column_names = L.pseudogenotype_mixing(list(genotype_names), doublet_prior)
        penalties = L.doublet_penalties(n_genotypes, doublet_prior)
        if Demultiplexer.aggregate_on_snps:
            logits = Demultiplexer._compute_logits_aggregating_on_snps(
                np.asarray(genotype_prob), mixing, penalties, molecule_calls, n_barcodes
            )
            return logits, column_names
        return Demultiplexer.compute_barcode_logits_using_barcode_calls(
            genotype_names, barcode_calls, doublet_prior, genotype_prob, n_barcodes, n_genotypes
        )

    @staticmethod
    def compute_barcode_logits_using_barcode_calls(
        genotype_names, barcode_calls, doublet_prior: float, genotype_prob: np.ndarray,
        n_barcodes: int, n_genotypes: int,
    ):
        """Dense log-likelihood accumulation over collapsed barcode calls."""
        mixing, column_names = L.pseudogenotype_mixing(list(genotype_names), doublet_prior)
        penalties = L.doublet_penalties(n_genotypes, doublet_prior)
        cb = np.asarray(barcode_calls["compressed_cb"], dtype=np.int32)
        order = stable_argsort(cb)
        logits = np.asarray(
            L.barcode_logits(
                jnp.asarray(np.asarray(genotype_prob, dtype=np.float32)),
                jnp.asarray(mixing),
                jnp.asarray(penalties),
                jnp.asarray(np.asarray(barcode_calls["variant_id"], dtype=np.int32)[order]),
                jnp.asarray(cb[order]),
                jnp.asarray(np.asarray(barcode_calls["p_base_wrong"], dtype=np.float32)[order]),
                n_barcodes,
                call_chunk=Demultiplexer.call_chunk,
            )
        )
        return logits, column_names

    @staticmethod
    def _compute_logits_aggregating_on_snps(
        genotype_prob: np.ndarray,
        mixing: np.ndarray,
        penalties: np.ndarray,
        molecule_calls: P.MoleculeCalls,
        n_barcodes: int,
        layout: Optional["_SnpAggregationLayout"] = None,
    ) -> np.ndarray:
        """Alternative per-SNP aggregation path (off by default).

        Normalizes per-(barcode, snp) logits by molecule-count^compensation
        and double log-softmaxes with a bad-SNP floor before collapsing to
        barcodes — limits over-contribution of any single SNP (reference:
        demuxalot/demux.py:204-244). The (barcode, snp) grouping is a pure
        function of the calls, so EM loops build it once
        (``_SnpAggregationLayout.build``) and pass it per iteration; the
        log/softmax/segment math runs on device
        (ops.likelihood.snp_aggregated_logits). NOTE: matching the
        reference, doublet penalties are NOT applied on this path
        (demuxalot/demux.py:239-244 computes but never adds them).
        """
        del penalties
        if layout is None:
            layout = _SnpAggregationLayout.build(molecule_calls)
        logits = _snp_aggregated_logits_jit(
            jnp.asarray(np.asarray(genotype_prob, dtype=np.float32)),
            jnp.asarray(mixing),
            layout.vid_by_group,
            layout.q_by_group,
            layout.group_of_call,
            layout.barcode_of_group,
            layout.calls_per_group,
            n_groups=layout.n_groups,
            n_barcodes=n_barcodes,
            compensation=float(Demultiplexer.compensation_during_computing_barcode_logits),
        )
        return np.asarray(logits)
