from greyjack_tpu_torch.parallel.islands import IslandRunner
from greyjack_tpu_torch.parallel.mesh import (IslandMesh, init_distributed,
                                              make_island_mesh)

__all__ = ["IslandRunner", "IslandMesh", "make_island_mesh",
           "init_distributed"]
