"""Global dtype / size configuration for greyjack_tpu_torch.

Mirrors `greyjack_tpu/config.py`: f32 chromosomes (discrete values are small
integers, exact below 2^24), i32 ids and route tables, f64 score rows, and
the same static move / tabu caps, so both packages draw identically shaped
moves and carry identically typed state.
"""

import torch

# dtype of chromosomes / move arithmetic (score rows are always f64); a
# `VariablesManager` reads it when it is built. Call `use_float64()` before
# building a model whose continuous variables need f64 chromosomes.
FLOAT_DTYPE = torch.float32


def use_float64():
    global FLOAT_DTYPE
    FLOAT_DTYPE = torch.float64


def use_float32():
    global FLOAT_DTYPE
    FLOAT_DTYPE = torch.float32

# dtype of integer columns handed to constraint kernels
INT_DTYPE = torch.int32

# maximum number of variables a single change / swap / swap_edges move touches
MAX_MOVE_SIZE = 8

# scramble windows are U{3..6} in the reference (`mover.rs:287`)
SCRAMBLE_MIN = 3
SCRAMBLE_MAX = 6

# static width of a move in delta form
DELTA_MOVE_SIZE = 2 * MAX_MOVE_SIZE

# the widest delta that `ops/moves.py` `dedupe_delta` and `ops/segments.py`
# `nunique_delta` analyse with their [K, K] forms: every random move's
# delta, where those forms take fewer launches than a sort; wider ones (the
# sweep's whole-tour winners) take sort forms that build no [K, K] mask
MAX_NARROW_DELTA = DELTA_MOVE_SIZE

# static cap on the per-group tabu ring buffer length
MAX_TABU_SIZE = 128
