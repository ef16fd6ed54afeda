"""The context quantisation tables of FFV1 above 8 bits.

QUANT9_10BIT and QUANT5_10BIT are FFmpeg ffv1enc.c's ``quant9_10bit``
and ``quant5_10bit``, written here as their runs.  ffv1enc.c uses them
wherever the samples have more than 8 bits: ``-context 0`` quantises
three sample differences with QUANT9_10BIT, ``-context 1`` two with
QUANT9_10BIT and three with QUANT5_10BIT, each indexed by the
difference's low 8 bits, with the same multipliers (1, 11, 121, 605,
3025) as the 8-bit tables.
"""

import numpy as np

_RUNS9 = [(0, 5), (1, 8), (2, 14), (3, 29), (4, 72), (-4, 73), (-3, 29),
          (-2, 14), (-1, 8), (0, 4)]
QUANT9_10BIT = np.concatenate([np.full(n, v, np.int32) for v, n in _RUNS9])
_RUNS5 = [(0, 11), (1, 39), (2, 78), (-2, 79), (-1, 39), (0, 10)]
QUANT5_10BIT = np.concatenate([np.full(n, v, np.int32) for v, n in _RUNS5])
