"""The least time one launch of the port's fused VRP delta kernel
(`greyjack_tpu_torch/csrc/vrp_delta.cu`) can take on one H100, from the
launch's own inputs.

Bytes: each input byte read once and each output byte written once. Of the
route table that is, for each route the launch's rows name, the slots a row
can read (its base length + kd + 1, at most the padded route width), of the
tables the kernel reads (six with time windows, three without), in whole
32-byte sectors; plus the rows' route column, four packed [rows, 8] int32
inputs and four [rows, 8] int32 outputs. Operations: about 40 int32
operations a readable slot a row. Peaks: 3.35 TB/s of HBM3, and 33.5 TOP/s
of int32 (64 int32 lanes a streaming multiprocessor: half the 67 TFLOP/s
float32 rate), NVIDIA's data sheet for the H100 SXM.
"""

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12


def bound(ctx_mat, av_col, n_stops, time_windowed, kd, n_islands):
    """(bytes, operations, bound_s, bound_by) of one launch on these
    inputs: ctx_mat int32 [I, K, 6 * Rp] (the routes' slot tables), av_col
    int32 [rows, 1] (each row's route)."""
    k, rp = ctx_mat.shape[1], ctx_mat.shape[-1] // 6
    n_rows = av_col.shape[0]
    isl = torch.arange(n_rows, device=av_col.device) // (n_rows // n_islands)
    route = isl * k + av_col[:, 0].long()
    base_len = (ctx_mat[..., :rp] < n_stops).sum(-1).reshape(-1)
    need = torch.clamp(base_len + kd + 1, max=rp)
    sectors = int(((need[torch.unique(route)] * 4 + 31) // 32).sum())
    tables = 6 if time_windowed else 3
    n_bytes = (tables * 32 * sectors + n_rows * 4
               + 4 * n_rows * 8 * 4 + 4 * n_rows * 8 * 4)
    n_ops = 40 * int(need[route].sum())
    bytes_s = n_bytes / HBM_BYTES_PER_S
    ops_s = n_ops / INT32_OPS_PER_S
    if bytes_s >= ops_s:
        return n_bytes, n_ops, bytes_s, "bytes"
    return n_bytes, n_ops, ops_s, "operations"
