"""sample_kernel_share (sampler: the plain step's move sampler kernel,
`greyjack_tpu_torch/ops/move_kernel.py`, whose launch the port's
`ops/moves.py` `move_population` wraps in a "gj.moves.kernel" span): 100
times the "gj.moves.kernel" ranges over the "gj.runner.step" ranges that
begin in the window, so 100 where every step launched the kernel and less
where steps ran the torch body. None where the trace has no step or no
"gj.moves.kernel" range at all (a program without the kernel)."""

from gjbench import tracing
from gjbench.metrics import _spans

KERNEL = "gj.moves.kernel"


def read(trace):
    steps = len(_spans.begun(trace, _spans.STEP))
    if not steps or not tracing.ranges_named(trace, KERNEL):
        return None
    return 100.0 * len(_spans.begun(trace, KERNEL)) / steps
