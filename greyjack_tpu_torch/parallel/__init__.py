from greyjack_tpu_torch.parallel.islands import IslandRunner

__all__ = ["IslandRunner"]
