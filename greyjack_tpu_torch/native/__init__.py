from greyjack_tpu_torch.native.gjio import (load_native, native_available,
                                            parse_instance)

__all__ = ["load_native", "native_available", "parse_instance"]
