"""Demultiplexing with custom SAM tags (non-cellranger pipelines).

The read filter is a plugin: pass a ``functools.partial`` of the standard
filter to change tag names or thresholds while KEEPING the fast C++ scanner
(an arbitrary lambda also works, but routes counting through the Python
scanner). BD Rhapsody users can import ``frontend.bd_rhapsody.parse_read``
which presets the 'MA' UMI tag.
"""
import sys
from pathlib import Path

# make the in-tree package importable when running straight from examples/
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from functools import partial

from demuxalot_tpu import (
    BarcodeHandler,
    Demultiplexer,
    ProbabilisticGenotypes,
    count_snps,
)
from demuxalot_tpu.frontend.cellranger import parse_read

DATA = "./example_data"
CELL_TAG = "CB"  # tag carrying the (corrected) cell barcode
UMI_TAG = "UB"  # tag carrying the molecule barcode

genotypes = ProbabilisticGenotypes(
    genotype_names=["Donor01", "Donor02", "Donor03", "Donor04"]
)
genotypes.add_vcf(f"{DATA}/test_genotypes.vcf")
barcode_handler = BarcodeHandler.from_file(f"{DATA}/test_barcodes.csv", tag=CELL_TAG)

# partial() keeps the native scanner; a lambda would fall back to Python
custom_filter = partial(parse_read, umi_tag=UMI_TAG, mapq_threshold=20)

snps = count_snps(
    bamfile_location=f"{DATA}/test_bamfile.bam",
    chromosome2positions=genotypes.get_chromosome2positions(),
    barcode_handler=barcode_handler,
    parse_read=custom_filter,
)
print({chrom: calls.n_snp_calls for chrom, calls in sorted(snps.items())})

learnt_genotypes, posteriors = Demultiplexer.learn_genotypes(
    snps,
    genotypes=genotypes,
    barcode_handler=barcode_handler,
    doublet_prior=0.25,
)
print(posteriors.idxmax(axis=1).value_counts())
