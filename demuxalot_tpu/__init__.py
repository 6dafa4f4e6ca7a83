"""Single-cell demultiplexing engine on JAX (XLA, and a fused E-step kernel on NVIDIA GPUs).

A from-scratch JAX/XLA/Pallas framework with the capabilities of demuxalot:
UMI-aware SNP counting from BAM files (CPU streaming frontend with its own
BGZF/BAM/BAI/VCF I/O), a dense barcode×SNP×genotype log-likelihood kernel
with doublet-aware posteriors, EM refinement of probabilistic genotype
betas, data-driven discovery of new discriminative SNPs, and multi-device
barcode-sharded execution over a ``jax.sharding`` mesh.

Public API mirrors the reference's five names
(demuxalot/__init__.py:3-7) plus framework extras.
"""

__version__ = "0.1.0"

from .utils.platform import tune_numpy_allocator as _tune_numpy_allocator

# hosts where THP faults stall make every large numpy buffer ~100x slower;
# harmless elsewhere (see utils/platform.py, opt out: DEMUX_NUMPY_HUGEPAGE=1)
_tune_numpy_allocator()

from .frontend.snp_counter import count_snps
from .models.demux import CompactPosteriors, Demultiplexer, PackedCalls
from .models.genotypes import ProbabilisticGenotypes
from .models.snp_detection import detect_snps_positions
from .utils.barcodes import BarcodeHandler

__all__ = [
    "BarcodeHandler",
    "CompactPosteriors",
    "Demultiplexer",
    "PackedCalls",
    "ProbabilisticGenotypes",
    "count_snps",
    "detect_snps_positions",
    "__version__",
]
