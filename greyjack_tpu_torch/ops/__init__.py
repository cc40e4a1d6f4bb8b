from greyjack_tpu_torch.ops import (lexico, segments, routes, distance, moves,
                                    selection, join)

__all__ = ["lexico", "segments", "routes", "distance", "moves", "selection",
           "join"]
