"""Plain demultiplexing: VCF genotypes + barcode whitelist -> posteriors.

Stages:
  1. load donor genotypes from a VCF into the probabilistic store
  2. collect UMI-consensus SNP evidence from the BAM (C++ scanner when
     available, transparently)
  3. EM-refine the genotypes while computing doublet-aware posteriors
  4. checkpoint the learnt betas for reuse in later runs
"""
import sys
from pathlib import Path

# make the in-tree package importable when running straight from examples/
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from demuxalot_tpu import (
    BarcodeHandler,
    Demultiplexer,
    ProbabilisticGenotypes,
    count_snps,
)
from demuxalot_tpu.utils import Timer

DATA = Path("./example_data")
DONORS = [f"Donor{i:02d}" for i in range(1, 5)]
CHECKPOINT = "/tmp/learnt_betas.parquet"


def load_inputs():
    store = ProbabilisticGenotypes(genotype_names=DONORS)
    store.add_vcf(str(DATA / "test_genotypes.vcf"))
    whitelist = BarcodeHandler.from_file(str(DATA / "test_barcodes.csv"))
    print(store)
    print(whitelist)
    return store, whitelist


def collect_evidence(store, whitelist):
    with Timer("snp counting"):
        per_chromosome = count_snps(
            bamfile_location=str(DATA / "test_bamfile.bam"),
            chromosome2positions=store.get_chromosome2positions(),
            barcode_handler=whitelist,
        )
    for chromosome in sorted(per_chromosome):
        calls = per_chromosome[chromosome]
        print(
            f"  {chromosome}: {calls.n_snp_calls} calls "
            f"from {calls.n_molecules} molecules"
        )
    return per_chromosome


def main():
    store, whitelist = load_inputs()
    evidence = collect_evidence(store, whitelist)

    # pack once: the calls<->variant join, collapse, kernel tilings, and
    # device uploads are shared by every entry point below (results are
    # bit-identical to passing `evidence` directly)
    packed = Demultiplexer.pack_dataset(evidence, store)

    with Timer("EM refinement + posteriors"):
        learnt, posteriors = Demultiplexer.learn_genotypes(
            packed,
            genotypes=store,
            barcode_handler=whitelist,
            doublet_prior=0.25,
            # tip: with a sparse/partial genotype prior and no labeled
            # barcodes, add damping="anchor" — it restricts learning to
            # prior-informed variants, which keeps the refinement monotone
            # where unrestricted EM can diverge (see docs/API.md)
        )

    # the betas parquet is a reusable checkpoint: feed it to
    # add_prior_betas in a later run to keep accumulating evidence
    learnt.save_betas(CHECKPOINT)
    print(f"\ncheckpointed learnt betas -> {CHECKPOINT}")

    print("\nassignment counts (columns are donors + doublet pairs):")
    print(posteriors.idxmax(axis=1).value_counts())
    print("\nfirst barcodes:")
    print(posteriors.round(3).head(8))

    # inference on the refined genotypes reuses the same packed dataset
    # (the learnt clone changes beta values only, not the variant registry)
    with Timer("posterior inference on learnt genotypes"):
        _logits, refined = Demultiplexer.predict_posteriors(
            packed, learnt, barcode_handler=whitelist, doublet_prior=0.25
        )
    print("\nassignments from the refined genotypes:")
    print(refined.idxmax(axis=1).value_counts())

    # link-frugal variant: at product scale the full posterior frame is
    # hundreds of MB of device->host transfer; the compact path reads back
    # only the device-computed top-k (assignments stay bit-identical to
    # the full-frame argmax)
    with Timer("compact posterior readback"):
        compact = Demultiplexer.predict_posteriors_compact(
            packed, learnt, barcode_handler=whitelist, doublet_prior=0.25
        )
    print(f"\ncompact readback: {compact.bytes_moved} bytes "
          f"(full frame: {refined.values.nbytes})")
    print(compact.to_dataframe().head(5))


if __name__ == "__main__":
    main()
