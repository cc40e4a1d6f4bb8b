from greyjack_tpu_torch.variables.planning_variables import GJFloat, GJInteger

__all__ = ["GJFloat", "GJInteger"]
