from greyjack_tpu_torch.models.nqueens.domain import (ChessBoard, Queen,
                                                      DomainBuilder)
from greyjack_tpu_torch.models.nqueens.cotwin_builder import (CotwinBuilder,
                                                              CotQueen)

__all__ = ["ChessBoard", "Queen", "DomainBuilder", "CotwinBuilder", "CotQueen"]
