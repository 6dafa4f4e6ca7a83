"""
Demultiplexing with data-driven detection of additional SNPs.

Flow (mirrors the reference's notebook example): load prior genotypes,
scan the BAM for new donor-discriminative positions starting from a rough
demultiplexing, merge the discovered positions back into the genotypes as
zero-weight variants, then EM-refine everything together.
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
    detect_snps_positions,
)

genotypes = ProbabilisticGenotypes(genotype_names=['Donor01', 'Donor02', 'Donor03', 'Donor04'])
genotypes.add_vcf('./example_data/test_genotypes.vcf')
barcode_handler = BarcodeHandler.from_file('./example_data/test_barcodes.csv')

# discover new SNPs from the data and export them as a positions-only prior
new_snps_filename = '/tmp/discovered_snps.parquet'
detect_snps_positions(
    './example_data/test_bamfile.bam',
    genotypes=genotypes,
    barcode_handler=barcode_handler,
    minimum_coverage=50,
    minimum_alternative_coverage=20,
    result_beta_prior_filename=new_snps_filename,
    joblib_verbosity=0,
)

# positions-only parquet adds variants with zero weight; EM will learn them
genotypes_with_discovered = genotypes.clone()
genotypes_with_discovered.add_prior_betas(new_snps_filename, prior_strength=10)

snps = count_snps(
    bamfile_location='./example_data/test_bamfile.bam',
    chromosome2positions=genotypes_with_discovered.get_chromosome2positions(),
    barcode_handler=barcode_handler,
)

learnt_genotypes, posterior_probabilities = Demultiplexer.learn_genotypes(
    snps,
    genotypes=genotypes_with_discovered,
    barcode_handler=barcode_handler,
    doublet_prior=0.25,
)

# learnt betas are the checkpoint: reuse them in later runs via add_prior_betas
learnt_genotypes.save_betas('/tmp/learnt_betas.parquet')

print('Result:')
print(posterior_probabilities.round(3))
