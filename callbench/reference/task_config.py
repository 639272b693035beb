"""The constants the frozen decoder reads (shared/param_p.py of
Clair3-RNA v0.2.2, as the program's config.py states them)."""

from itertools import accumulate

FLANKING_BASE_NUM = 16
NO_OF_POSITIONS = 2 * FLANKING_BASE_NUM + 1
LABEL_SHAPE = [21, 3, NO_OF_POSITIONS, NO_OF_POSITIONS]
LABEL_SHAPE_CUM = list(accumulate(LABEL_SHAPE))
MAX_VARIANT_LENGTH = 50
MAX_VARIANT_LENGTH_LONG_INDEL = 100000
LONG_INDEL_DISTANCE_PROPORTION = 0.1
