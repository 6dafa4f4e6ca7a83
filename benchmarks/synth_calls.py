"""Bench-shape synthetic truth as registry + CompressedSNPCalls (no side effects).

Shared by the at-scale quality harness and the full-stack parity fuzz test;
importable without touching the jax backend.
"""
import numpy as np


def synthesize_compressed_calls(
    n_barcodes: int,
    n_donors: int,
    n_snps: int,
    calls_per_barcode: int,
    doublets_fraction: float = 0.2,
    flip_prob: float = 0.02,
    seed: int = 0,
):
    """Bench-shape synthetic truth as (genotypes, calls, truth_donors).

    Same generative model as ``sim.synthesize_device_workload`` (two alleles
    per SNP, per-donor allele at beta 100 vs 0.5, small per-call flip) but
    emitted as real registry + CompressedSNPCalls objects so the run goes
    through the production packing/EM path, plus doublet barcodes.
    """
    from demuxalot_tpu.frontend.snp_counter import (
        MOLECULE_DTYPE, SNP_CALL_DTYPE, CompressedSNPCalls,
    )
    from demuxalot_tpu.models.genotypes import ProbabilisticGenotypes

    rng = np.random.RandomState(seed)
    donor_names = [f"Donor{i + 1:02}" for i in range(n_donors)]
    donor_allele = rng.randint(0, 2, size=(n_snps, n_donors))

    # registry: two variants per SNP ("A" = allele 0, "C" = allele 1),
    # insertion in SNP order so the packed layout matches the bench shape
    genotypes = ProbabilisticGenotypes(donor_names)
    bases = ("A", "C")
    for pos in range(n_snps):
        for allele in (0, 1):
            genotypes.get_variant_id("chr1", pos, bases[allele])
    betas = np.full((2 * n_snps, n_donors), 0.5, dtype=np.float32)
    rows = np.arange(n_snps) * 2
    for donor in range(n_donors):
        betas[rows + donor_allele[:, donor], donor] = 100.0
    genotypes = genotypes._with_betas(betas)

    # barcode truth: one donor, or two distinct donors for doublets
    primary = rng.randint(0, n_donors, size=n_barcodes)
    is_doublet = rng.rand(n_barcodes) < doublets_fraction
    secondary = (primary + 1 + rng.randint(0, n_donors - 1, size=n_barcodes)) % n_donors
    truth = [
        sorted({donor_names[primary[b]], donor_names[secondary[b]]})
        if is_doublet[b] else [donor_names[primary[b]]]
        for b in range(n_barcodes)
    ]

    n_calls = n_barcodes * calls_per_barcode
    cb = np.repeat(np.arange(n_barcodes, dtype=np.int32), calls_per_barcode)
    # per call: pick one of the barcode's donors, emit that donor's allele
    use_secondary = is_doublet[cb] & (rng.rand(n_calls) < 0.5)
    call_donor = np.where(use_secondary, secondary[cb], primary[cb])
    snp = rng.randint(0, n_snps, size=n_calls).astype(np.int32)
    allele = donor_allele[snp, call_donor]
    flip = rng.rand(n_calls) < flip_prob
    allele = np.where(flip, 1 - allele, allele).astype(np.int64)
    q = (0.1 ** (0.1 * rng.randint(20, 41, size=n_calls))).astype(np.float32)

    molecules = np.empty(n_calls, dtype=MOLECULE_DTYPE)
    molecules["compressed_cb"] = cb
    molecules["compressed_ub"] = np.arange(n_calls, dtype=np.int32)
    molecules["p_group_misaligned"] = 0.01
    snp_calls = np.empty(n_calls, dtype=SNP_CALL_DTYPE)
    snp_calls["molecule_index"] = np.arange(n_calls, dtype=np.int32)
    snp_calls["snp_position"] = snp
    # base codes: A=0, C=1 (utils.encoding.base_lookup)
    snp_calls["base_index"] = allele.astype(np.uint8)
    snp_calls["p_base_wrong"] = q

    calls = CompressedSNPCalls()
    calls.molecules = molecules
    calls.snp_calls = snp_calls
    calls._finalized = True
    return genotypes, {"chr1": calls}, truth, donor_names
