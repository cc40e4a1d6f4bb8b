from greyjack_tpu_torch.score_calculation.score_requesters.variables_manager import (
    VariablesManager,
)
from greyjack_tpu_torch.score_calculation.score_requesters.score_requester import (
    ScoreRequester,
)

__all__ = ["VariablesManager", "ScoreRequester"]
