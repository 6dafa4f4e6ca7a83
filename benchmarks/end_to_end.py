"""End-to-end pipeline benchmark: BAM in → posteriors out, stage-timed.

The product-level number: the reference's marketed edge is pipeline speed
(the reference's README.md:77, multiprocessing counting,
demuxalot/snp_counter.py:279-385) — this harness measures
the pipeline a user actually runs, at a realistic scale (32 donors,
65,536 barcodes, 8 chromosomes), against a measured reference-style
baseline on the SAME inputs:

* counting: the C++ scanner vs this repo's Python scanner (the same
  per-read/per-molecule algorithm the reference runs through pysam);
* EM + posteriors: the reference package's own numpy implementation
  (imported through tests/reference_adapter.py with pysam stubbed, exactly
  as the parity tests do) vs the device EM.

Writes ``E2E.json`` (or ``E2E_PMBC.json`` with ``--pmbc``) at the repo root
and prints it. Reproduce with:

    python bench.py --end-to-end          # full artifact (~15 min)
    python bench.py --end-to-end --pmbc   # preprint scale (~30 min)
    python bench.py --end-to-end --quick  # small-shape smoke (~1 min)

The companion harness ``benchmarks/at_scale_quality.py`` records the
bench-shape truth-accuracy section (``at_scale``) into QUALITY.json.
"""
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

from demuxalot_tpu.utils.platform import (
    DEFAULT_COMPILATION_CACHE_DIR, enable_persistent_compilation_cache,
)

CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_COMPILATION_CACHE_DIR)
CACHE_ENTRIES_BEFORE = (
    len(os.listdir(CACHE_DIR)) if os.path.isdir(CACHE_DIR) else 0
)
enable_persistent_compilation_cache()


sys.path.insert(0, str(REPO / "benchmarks"))
from _metrics import doublet_metrics, singlet_loss  # noqa: E402


def _stage(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _truth_list(barcode2donor_names, probs_df):
    """De-duplicated truth aligned with the posterior dataframe's rows.

    BarcodeHandler SORTS the whitelist, so alignment must go through the
    dataframe index, not the generator dict's insertion order.
    """
    return [sorted(set(barcode2donor_names[b])) for b in probs_df.index]


def main(argv=None):
    import tempfile

    import jax

    from demuxalot_tpu import BarcodeHandler, Demultiplexer, count_snps
    from demuxalot_tpu.sim import generate_bam_file

    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    pmbc = "--pmbc" in argv
    skip_baseline = "--skip-baseline" in argv

    mutation_prob = 0.003
    if quick:
        n_donors, n_barcodes, n_reads = 16, 4000, 20
        chrom2len = {f"chr{i}": 10_000 for i in range(1, 5)}
    elif pmbc:
        # the preprint's scale regime (README.md:36-41, 57: 32 donors,
        # SNP-array variant counts): ~350k polymorphic sites / ~800k
        # variants over a 2.4 Mbp synthetic genome, 131k barcodes — the
        # shape where the E-step's variant banding engages in production
        n_donors, n_barcodes, n_reads = 32, 131_072, 15
        chrom2len = {f"chr{i}": 300_000 for i in range(1, 9)}
        mutation_prob = 0.005
    else:
        n_donors, n_barcodes, n_reads = 32, 65_536, 20
        chrom2len = {f"chr{i}": 20_000 for i in range(1, 9)}
    em_iterations = 5

    backend = jax.default_backend()
    np.random.seed(0)
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        _stage(f"generating BAM: {n_donors} donors x {n_barcodes} barcodes "
               f"x {n_reads} reads, {len(chrom2len)} chromosomes")
        t0 = time.perf_counter()
        filename, genotypes, _ids, barcode2donor_names = generate_bam_file(
            str(Path(tmp) / "e2e.bam"),
            n_genotypes=n_donors,
            n_barcodes=n_barcodes,
            n_reads_per_barcode=n_reads,
            mutation_prob=mutation_prob,
            chromosome2length=chrom2len,
        )
        stages["fixture_generate_bam_s"] = round(time.perf_counter() - t0, 2)
        handler = BarcodeHandler(list(barcode2donor_names))
        positions = genotypes.get_chromosome2positions()
        total_reads = n_barcodes * n_reads
        bam_bytes = os.path.getsize(filename)

        # --- stage 1: counting (C++ scanner; the pipeline's ingest) --------
        _stage("counting (native C++ scanner)")
        t0 = time.perf_counter()
        calls = count_snps(filename, positions, handler, joblib_n_jobs=8,
                           joblib_verbosity=0, native=True)
        stages["count_native_s"] = round(time.perf_counter() - t0, 2)
        stages["native_reads_per_s"] = round(total_reads / stages["count_native_s"], 1)
        n_molecule_calls = int(sum(c.n_snp_calls for c in calls.values()))

        # --- stage 2: packing (calls ↔ variants join, collapse, priors) ----
        _stage("packing")
        t0 = time.perf_counter()
        _v2s, _betas, _mol, barcode_calls = Demultiplexer.pack_calls(
            calls, genotypes, add_data_prior=True
        )
        stages["pack_calls_s"] = round(time.perf_counter() - t0, 2)
        n_barcode_calls = int(len(barcode_calls))

        # --- stage 3: EM refinement (cold = incl. compile, then warm) ------
        # the cold runs are instrumented too (detail discarded) so any
        # per-shape programs the hook issues are compiled before the warm
        # run measures
        from demuxalot_tpu.models import demux as demux_mod

        _stage("EM learn_genotypes (cold, incl. jit compile)")
        demux_mod.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        _learnt, probs_em = Demultiplexer.learn_genotypes(
            calls, genotypes, barcode_handler=handler, n_iterations=em_iterations
        )
        stages["learn_genotypes_cold_s"] = round(time.perf_counter() - t0, 2)
        _stage("EM learn_genotypes (warm, stage-instrumented)")
        demux_mod.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        _learnt, probs_em = Demultiplexer.learn_genotypes(
            calls, genotypes, barcode_handler=handler, n_iterations=em_iterations
        )
        stages["learn_genotypes_warm_instrumented_s"] = round(
            time.perf_counter() - t0, 2
        )
        learn_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = None
        # headline warm number measured WITHOUT the stage hook: the hook's
        # device syncs and forced upload flush serialize host/device overlap.
        # min-of-2: the same discipline every other timing in this repo uses
        _stage("EM learn_genotypes (warm, uninstrumented headline, min of 2)")
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            _learnt, probs_em = Demultiplexer.learn_genotypes(
                calls, genotypes, barcode_handler=handler, n_iterations=em_iterations
            )
            times.append(time.perf_counter() - t0)
        stages["learn_genotypes_warm_s"] = round(min(times), 2)

        # --- stage 4: posterior inference (doublet-aware) -------------------
        _stage("predict_posteriors (cold)")
        demux_mod.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        _lg, probs = Demultiplexer.predict_posteriors(
            calls, genotypes, barcode_handler=handler, doublet_prior=0.35
        )
        stages["predict_posteriors_cold_s"] = round(time.perf_counter() - t0, 2)
        _stage("predict_posteriors (warm, stage-instrumented)")
        demux_mod.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        _lg, probs = Demultiplexer.predict_posteriors(
            calls, genotypes, barcode_handler=handler, doublet_prior=0.35
        )
        stages["predict_posteriors_warm_instrumented_s"] = round(
            time.perf_counter() - t0, 2
        )
        predict_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = None
        _stage("predict_posteriors (warm, uninstrumented headline, min of 2)")
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            _lg, probs = Demultiplexer.predict_posteriors(
                calls, genotypes, barcode_handler=handler, doublet_prior=0.35
            )
            times.append(time.perf_counter() - t0)
        stages["predict_posteriors_warm_s"] = round(min(times), 2)

        # --- pack-once engine flow (the recommended product usage) ---------
        # PackedCalls shares the join/collapse/tiling/upload between the EM
        # and posterior entry points; the per-call flow above stays the
        # like-for-like comparison against the reference's API shape
        _stage("pack-once engine flow (pack_dataset + learn + predict)")
        demux_mod.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        packed = Demultiplexer.pack_dataset(calls, genotypes)
        _learnt_e, _probs_em_e = Demultiplexer.learn_genotypes(
            packed, genotypes, barcode_handler=handler, n_iterations=em_iterations
        )
        lg_e, _probs_e = Demultiplexer.predict_posteriors(
            packed, genotypes, barcode_handler=handler, doublet_prior=0.35
        )
        engine_first = time.perf_counter() - t0
        engine_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = None
        # second pass measures the flow a long-lived engine actually pays
        # (fresh PackedCalls, but layouts/jits warm); headline = min of 2,
        # uninstrumented, matching the per-call headlines above
        t0 = time.perf_counter()
        packed = Demultiplexer.pack_dataset(calls, genotypes)
        _learnt_e, _probs_em_e = Demultiplexer.learn_genotypes(
            packed, genotypes, barcode_handler=handler, n_iterations=em_iterations
        )
        lg_e, _probs_e = Demultiplexer.predict_posteriors(
            packed, genotypes, barcode_handler=handler, doublet_prior=0.35
        )
        stages["engine_flow_warm_s"] = round(
            min(engine_first, time.perf_counter() - t0), 2
        )
        engine_matches = bool(
            np.allclose(lg_e.values, _lg.values, rtol=1e-6, atol=1e-6)
        )

        # --- compact posterior output (link-frugal top-k readback) ---------
        # the full-frame path above moves 4*n_pg bytes/barcode over the
        # link; the opt-in compact path moves device
        # top-k + logsumexp instead and must keep assignments bit-identical
        _stage("predict_posteriors_compact (cold, incl. top-k compile)")
        t0 = time.perf_counter()
        compact = Demultiplexer.predict_posteriors_compact(
            packed, genotypes, barcode_handler=handler, doublet_prior=0.35,
            k=4,
        )
        t_compact_cold = round(time.perf_counter() - t0, 2)
        _stage("predict_posteriors_compact (warm)")
        t0 = time.perf_counter()
        compact = Demultiplexer.predict_posteriors_compact(
            packed, genotypes, barcode_handler=handler, doublet_prior=0.35,
            k=4,
        )
        t_compact = round(time.perf_counter() - t0, 2)
        full_frame_bytes = int(_lg.values.nbytes)
        compact_output = {
            "warm_s": t_compact,
            "cold_s": t_compact_cold,
            "bytes_moved": compact.bytes_moved,
            "full_logits_frame_bytes": full_frame_bytes,
            "bytes_fraction_of_full": round(
                compact.bytes_moved / full_frame_bytes, 4
            ),
            "assignments_match_full_argmax": bool(
                np.array_equal(
                    compact.assignment, _lg.values.argmax(axis=1)
                )
            ),
            "top_logits_exact_frame_entries": bool(
                np.array_equal(
                    compact.top_logits,
                    _lg.values[
                        np.arange(len(compact.assignment))[:, None],
                        compact.top_index,
                    ],
                )
            ),
            "note": "device-side top-4 (assignment, runner-up, margin, "
                    "probs via logsumexp); full f32 frames remain the "
                    "default predict_posteriors contract",
        }

        # --- sharded engine (mesh of the local devices), stage-timed -------
        # same packed dataset: the shard layouts cache on it, so the
        # predict-after-learn flow must re-tile nothing (cache counters
        # recorded). The mesh spans every visible card; with
        # jax.distributed the same code path spans hosts.
        _stage("sharded engine flow (learn + predict on the local mesh)")
        from demuxalot_tpu.parallel import ShardedDemultiplexer, make_mesh

        sharded_engine = ShardedDemultiplexer(make_mesh())
        t0 = time.perf_counter()
        sharded_engine.learn_genotypes(
            packed, genotypes, barcode_handler=handler, n_iterations=em_iterations
        )
        t_sharded_learn_cold = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        sharded_engine.predict_posteriors(
            packed, genotypes, barcode_handler=handler, doublet_prior=0.35
        )
        t_sharded_predict_cold = round(time.perf_counter() - t0, 2)
        demux_mod.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        _learnt_s, _probs_s = sharded_engine.learn_genotypes(
            packed, genotypes, barcode_handler=handler, n_iterations=em_iterations
        )
        t_sharded_learn = round(time.perf_counter() - t0, 2)
        sharded_learn_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = {}
        t0 = time.perf_counter()
        lg_s, _pr_s = sharded_engine.predict_posteriors(
            packed, genotypes, barcode_handler=handler, doublet_prior=0.35
        )
        t_sharded_predict = round(time.perf_counter() - t0, 2)
        sharded_predict_detail = demux_mod.STAGE_TIMINGS
        demux_mod.STAGE_TIMINGS = None
        sharded_section = {
            "mesh_devices": int(sharded_engine.n_shards),
            "learn_genotypes_cold_s": t_sharded_learn_cold,
            "predict_posteriors_cold_s": t_sharded_predict_cold,
            "learn_genotypes_s": t_sharded_learn,
            "predict_posteriors_s": t_sharded_predict,
            "layout_cache_hits": int(sharded_engine.layout_cache_hits),
            "layout_cache_misses": int(sharded_engine.layout_cache_misses),
            "logits_close_to_single_device": bool(
                np.allclose(lg_s.values, _lg.values, rtol=1e-4, atol=5e-3)
            ),
            "stages_detail": {
                "learn": sharded_learn_detail,
                "predict": sharded_predict_detail,
            },
        }

        # measured link accounting: which part of the warm wall-clock is the
        # host<->device link (uploads of the call tables + posterior frame
        # readbacks) vs host packing/tiling vs device compute. Every number
        # here is measured in THIS run, with device syncs between phases.
        link_keys_s = ("upload_flush_s", "d2h_logits_s", "d2h_probs_s",
                       "d2h_addition_s")
        link_byte_keys = ("h2d_bytes", "d2h_logits_bytes", "d2h_probs_bytes",
                          "d2h_addition_bytes")
        link_s = round(sum(d.get(k, 0.0) for d in (learn_detail, predict_detail)
                           for k in link_keys_s), 2)
        link_bytes = int(sum(d.get(k, 0) for d in (learn_detail, predict_detail)
                             for k in link_byte_keys))
        warm_sum = stages["learn_genotypes_warm_s"] + stages["predict_posteriors_warm_s"]
        link_accounting = {
            "link_s": link_s,
            "link_bytes": link_bytes,
            "measured_link_bytes_per_s": round(link_bytes / link_s, 1) if link_s else None,
            "warm_em_plus_predict_s": round(warm_sum, 2),
            "warm_em_plus_predict_excluding_link_s": round(warm_sum - link_s, 2),
            "note": "link_s = measured wall seconds the instrumented warm runs "
                    "spent moving call tables to the device and posterior/"
                    "addition frames back (device-synced phase timings, "
                    "stages_detail); warm_em_plus_predict_s is the separate "
                    "UNinstrumented headline, so the difference vs the "
                    "instrumented stage sums is observer overhead",
        }

        ours_total_warm = round(
            stages["count_native_s"]
            + stages["learn_genotypes_warm_s"]
            + stages["predict_posteriors_warm_s"], 2,
        )
        truth = _truth_list(barcode2donor_names, probs)
        quality = {
            "loss_em": round(singlet_loss(probs_em, truth), 4),
            "loss_predict": round(singlet_loss(probs, truth), 4),
            **doublet_metrics(probs, truth),
        }

        # --- reference-style baseline on the SAME inputs --------------------
        baseline = None
        if not skip_baseline:
            _stage("baseline: Python scanner counting")
            t0 = time.perf_counter()
            calls_py = count_snps(filename, positions, handler, joblib_n_jobs=8,
                                  joblib_verbosity=0, native=False)
            t_count_py = round(time.perf_counter() - t0, 2)
            del calls_py

            sys.path.insert(0, str(REPO / "tests"))
            from reference_adapter import (
                load_reference, to_reference_calls, to_reference_genotypes,
            )

            reference = load_reference()
            ref_times = {}
            ref_quality = {}
            if reference is not None:
                _stage("baseline: reference numpy EM (5 iterations)")
                ref_genotypes = to_reference_genotypes(reference, genotypes, tmp)
                ref_calls = to_reference_calls(reference, calls)
                ref_handler = reference.BarcodeHandler(list(barcode2donor_names))
                t0 = time.perf_counter()
                _ref_learnt, ref_probs_em = reference.Demultiplexer.learn_genotypes(
                    ref_calls, ref_genotypes, ref_handler,
                    n_iterations=em_iterations, doublet_prior=0.0,
                )
                ref_times["learn_genotypes_s"] = round(time.perf_counter() - t0, 2)
                _stage("baseline: reference predict_posteriors (doublets)")
                t0 = time.perf_counter()
                _ref_lg, ref_probs = reference.Demultiplexer.predict_posteriors(
                    ref_calls, ref_genotypes, ref_handler, doublet_prior=0.35,
                )
                ref_times["predict_posteriors_s"] = round(time.perf_counter() - t0, 2)
                ref_quality = {
                    "loss_em": round(singlet_loss(ref_probs_em, truth), 4),
                    "loss_predict": round(singlet_loss(ref_probs, truth), 4),
                    **doublet_metrics(ref_probs, truth),
                }
                ref_total = round(
                    t_count_py + ref_times["learn_genotypes_s"]
                    + ref_times["predict_posteriors_s"], 2,
                )
            else:
                ref_total = None
            baseline = {
                "count_python_s": t_count_py,
                "python_reads_per_s": round(total_reads / t_count_py, 1),
                **ref_times,
                "total_pipeline_s": ref_total,
                "quality": ref_quality,
                "note": "Python scanner = same per-read/molecule algorithm the "
                        "reference runs via pysam; EM/posteriors = the reference "
                        "package itself (numpy), via tests/reference_adapter.py",
            }

    result = {
        "benchmark": "end_to_end_pipeline",
        "backend": backend,
        "device_kind": jax.devices()[0].device_kind,
        # "_cold_s" stages include jit compiles; with a primed on-disk
        # executable cache they replay from disk instead — this records
        # which one this was
        "persistent_compile_cache": {
            "dir": CACHE_DIR,
            "entries_at_start": CACHE_ENTRIES_BEFORE,
        },
        "reproduce": "python bench.py --end-to-end",
        "config": {
            "n_donors": n_donors,
            "n_barcodes": n_barcodes,
            "n_reads_per_barcode": n_reads,
            "chromosomes": len(chrom2len),
            "chromosome_length": next(iter(chrom2len.values())),
            "mutation_prob": mutation_prob,
            "doublets_fraction": 0.2,
            "em_iterations": em_iterations,
            "n_reads": n_barcodes * n_reads,
            "bam_bytes": bam_bytes,
            "n_molecule_calls": n_molecule_calls,
            "n_barcode_calls": n_barcode_calls,
        },
        "stages": stages,
        "stages_detail": {
            "learn_genotypes_warm": learn_detail,
            "predict_posteriors_warm": predict_detail,
            "engine_flow_warm": engine_detail,
        },
        "link_accounting": link_accounting,
        "total_pipeline_warm_s": ours_total_warm,
        "engine_flow": {
            "total_pipeline_s": round(
                stages["count_native_s"] + stages["engine_flow_warm_s"], 2
            ),
            "logits_match_per_call_flow": engine_matches,
            "note": "pack-once PackedCalls engine (Demultiplexer.pack_dataset): "
                    "join/collapse/tiling/upload shared between learn_genotypes "
                    "and predict_posteriors; the headline total_pipeline_warm_s "
                    "keeps the per-call flow for like-for-like comparison",
        },
        "compact_output": compact_output,
        "sharded_engine": sharded_section,
        "quality": quality,
        "baseline_reference_style": baseline,
    }
    if baseline and baseline.get("total_pipeline_s"):
        result["vs_baseline_total"] = round(
            baseline["total_pipeline_s"] / ours_total_warm, 2
        )
        result["vs_baseline_counting"] = round(
            baseline["count_python_s"] / stages["count_native_s"], 2
        )
        result["engine_flow"]["vs_baseline_total"] = round(
            baseline["total_pipeline_s"] / result["engine_flow"]["total_pipeline_s"], 2
        )

    # --quick must never overwrite a committed artifact with a smoke shape
    if pmbc and not quick:
        result["reproduce"] = "python bench.py --end-to-end --pmbc"
        (REPO / "E2E_PMBC.json").write_text(json.dumps(result, indent=1) + "\n")
    elif not pmbc and not quick:
        (REPO / "E2E.json").write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
