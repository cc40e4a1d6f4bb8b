"""plain_kernel_share (plain score: the VRP plain score's route analysis
kernel, `greyjack_tpu_torch/ops/plain_kernel.py`, whose launch the port's
`models/vrp/cotwin_builder.py` `build_common` wraps in a "gj.score.kernel"
span inside "gj.score.plain"): 100 times the "gj.score.kernel" ranges over
the "gj.score.plain" ranges that begin in the window, so 100 where every
plain score launched the kernel and less where some ran the torch body.
None where the trace has no plain score or no "gj.score.kernel" range at
all (a program without the kernel)."""

from gjbench import tracing
from gjbench.metrics import _spans

KERNEL = "gj.score.kernel"
PLAIN = "gj.score.plain"


def read(trace):
    scores = len(_spans.begun(trace, PLAIN))
    if not scores or not tracing.ranges_named(trace, KERNEL):
        return None
    return 100.0 * len(_spans.begun(trace, KERNEL)) / scores
