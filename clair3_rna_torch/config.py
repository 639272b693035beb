"""Pipeline constants and platform presets.

Numeric behavior mirrors the reference constants module (shared/param_p.py:1-93
in HKU-BAL/Clair3-RNA) so that calls are VCF-comparable; the representation is
redesigned around an immutable dataclass instead of module globals.
"""

from dataclasses import dataclass, field, replace
from itertools import accumulate

VERSION = "0.1.0"
REFERENCE_VERSION = "0.2.2"  # Clair3-RNA version whose behavior we match

# ---------------------------------------------------------------------------
# Pileup channel layout (shared/param_p.py:31).
# Upper case = forward strand, lower case = reverse strand.
#   A C G T     : per-base counts (ref base stored negated, see builder)
#   I / i       : total insertion-read count by strand
#   I1 / i1     : read count of the most supported single insertion allele
#   D / d       : total deletion-read count by strand
#   D1 / d1     : read count of the most supported single deletion allele
#   * / #       : in-deletion placeholder counts (samtools --reverse-del:
#                 '*' forward strand, '#' reverse strand)
# ---------------------------------------------------------------------------
CHANNELS = ("A", "C", "G", "T", "I", "I1", "D", "D1", "*",
            "a", "c", "g", "t", "i", "i1", "d", "d1", "#")
CHANNEL_SIZE = len(CHANNELS)
CHANNEL_INDEX = {name: idx for idx, name in enumerate(CHANNELS)}

# Extra channels when calling with haplotagged reads (HP:1 = P, HP:2 = M)
# (src/create_tensor_pileup.py:181-217).
PHASED_CHANNELS = ("AP", "CP", "GP", "TP", "IP", "DP",
                   "AM", "CM", "GM", "TM", "IM", "DM")
PHASED_CHANNEL_SIZE = len(PHASED_CHANNELS)

FLANKING_BASE_NUM = 16
NO_OF_POSITIONS = 2 * FLANKING_BASE_NUM + 1  # 33

# Model output layout: gt21(21) + zygosity(3) + two variant-length heads(33+33)
LABEL_SHAPE = [21, 3, NO_OF_POSITIONS, NO_OF_POSITIONS]
LABEL_SIZE = sum(LABEL_SHAPE)
LABEL_SHAPE_CUM = list(accumulate(LABEL_SHAPE))

# Read / site filters (shared/param_p.py:11-23, 41, 85-92)
MIN_MQ = 5
MIN_BQ = 0
MIN_AF = 0.08
MIN_AF_BY_PLATFORM = {"ont": 0.15, "hifi": MIN_AF, "ilmn": MIN_AF}
MAX_DEPTH = 144
MAX_DEPTH_BY_PLATFORM = {"ont": MAX_DEPTH, "hifi": MAX_DEPTH, "ilmn": MAX_DEPTH}
SNP_MIN_AF = 0.08
INDEL_MIN_AF = 0.15
MIN_COVERAGE = 4
# BAM records excluded from pileup: UNMAP|SECONDARY|QCFAIL|DUP (samtools
# --excl-flags 2316, shared/param_p.py:41)
EXCLUDE_FLAGS = 2316
MAX_VARIANT_LENGTH = 50
MAX_VARIANT_LENGTH_LONG_INDEL = 100000
LONG_INDEL_DISTANCE_PROPORTION = 0.1
SKIP_PROPORTION_THRESHOLD = 0.2  # splice-junction padding trigger
EXPAND_REFERENCE_REGION = 1000
CHUNK_SIZE = 5_000_000  # genome shard size per work item
QUAL_CUTOFF_BY_PLATFORM = {"ont": 8, "hifi": 2}

# GVCF parameters (shared/param_p.py:26-27)
BASE_ERR = 0.001
GQ_BIN_SIZE = 5

# Inference / training batch shapes (shared/param_p.py:49-57)
PREDICT_BATCH_SIZE = 200     # reference batch size; we use larger device batches
TRAIN_BATCH_SIZE = 2000
INITIAL_LEARNING_RATE = 1e-3
L2_REGULARIZATION_LAMBDA = 1e-7
TRAINING_DATASET_PERCENTAGE = 0.9
MAX_EPOCH = 30

SUPPORTED_PLATFORMS = {"ont", "hifi", "ilmn"}
SUPPORTED_FULL_PLATFORMS = {
    "ont_dorado_drna004",
    "ont_guppy_drna002",
    "ont_r9_guppy_cdna",
    "ont_r10_dorado_cdna",
    "hifi_sequel2_pbmm2",
    "hifi_sequel2_minimap2",
    "hifi_mas_pbmm2",
    "hifi_mas_minimap2",
}
PLATFORM_ALIASES = {
    "ont_guppy_cdna": "ont_r9_guppy_cdna",
    "ont_r9_guppy_drna": "ont_guppy_drna002",
    "hifi_sequel2": "hifi_sequel2_pbmm2",
    "hifi_mas": "hifi_mas_pbmm2",
}
PHASING_SUPPORTED_PLATFORMS = {
    "ont_dorado_drna004",
    "ont_r10_dorado_cdna",
    "hifi_mas_minimap2",
    "hifi_sequel2_minimap2",
}
REDIPORTAL_FILTER_TAGS = "A,D:A,R:A,R,D"


def short_platform(full_platform: str) -> str:
    """Collapse a full platform string to its 'ont'/'hifi'/'ilmn' family."""
    if full_platform in SUPPORTED_PLATFORMS:
        return full_platform
    full_platform = PLATFORM_ALIASES.get(full_platform, full_platform)
    for prefix in ("ont", "hifi", "ilmn"):
        if full_platform.startswith(prefix):
            return prefix
    raise ValueError(f"unknown platform: {full_platform}")


@dataclass(frozen=True)
class PileupConfig:
    """Configuration of one pileup calling run (tensor builder + caller)."""

    platform: str = "ont"              # 'ont' | 'hifi' | 'ilmn'
    full_platform: str = "ont_dorado_drna004"
    min_mq: int = MIN_MQ
    min_bq: int = MIN_BQ
    min_coverage: int = MIN_COVERAGE
    snp_min_af: float = SNP_MIN_AF
    indel_min_af: float = INDEL_MIN_AF
    max_depth: int = MAX_DEPTH
    exclude_flags: int = EXCLUDE_FLAGS
    fast_mode: bool = False
    call_snp_only: bool = False
    phased: bool = False               # 30-channel haplotagged tensors
    enable_head_tail: bool = False     # sequence head/tail calling
    enable_splice_padding: bool = False
    show_ref: bool = False
    qual_cutoff: float | None = None   # LowQual threshold for final VCF
    max_variant_length: int = MAX_VARIANT_LENGTH
    enable_long_indel: bool = False
    sample_name: str = "SAMPLE"
    # device-side batching
    batch_size: int = 2048
    tile_size: int = 1 << 14           # genome positions per device tile

    @property
    def channel_size(self) -> int:
        return CHANNEL_SIZE + (PHASED_CHANNEL_SIZE if self.phased else 0)

    @property
    def effective_indel_min_af(self) -> float:
        if self.indel_min_af >= 0:
            return self.indel_min_af
        return MIN_AF_BY_PLATFORM[self.platform]

    @property
    def effective_snp_af(self) -> float:
        snp_af = self.snp_min_af if self.snp_min_af >= 0 else MIN_AF
        if self.platform == "ont" and self.fast_mode:
            snp_af = max(snp_af, MIN_AF_BY_PLATFORM[self.platform])
        return snp_af

    @property
    def effective_qual_cutoff(self) -> float:
        if self.qual_cutoff is not None:
            return self.qual_cutoff
        return QUAL_CUTOFF_BY_PLATFORM.get(self.platform, 2)

    def with_(self, **kwargs) -> "PileupConfig":
        return replace(self, **kwargs)

    @classmethod
    def for_platform(cls, full_platform: str, **kwargs) -> "PileupConfig":
        full = PLATFORM_ALIASES.get(full_platform, full_platform)
        if full not in SUPPORTED_FULL_PLATFORMS and full not in SUPPORTED_PLATFORMS:
            raise ValueError(f"unsupported platform: {full_platform}")
        return cls(platform=short_platform(full), full_platform=full, **kwargs)
