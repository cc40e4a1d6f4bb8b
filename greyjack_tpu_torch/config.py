"""Global dtype / size configuration for greyjack_tpu_torch.

Mirrors `greyjack_tpu/config.py`: f32 chromosomes (discrete values are small
integers, exact below 2^24), i32 ids and route tables, f64 score rows, and
the same static move / tabu caps, so both packages draw identically shaped
moves and carry identically typed state.
"""

import torch

# dtype of chromosomes / move arithmetic (score rows are always f64)
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

# static cap on the per-group tabu ring buffer length
MAX_TABU_SIZE = 128
