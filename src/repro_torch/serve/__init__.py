from repro_torch.serve.engine import (ReconfigurableGroup, Request,
                                      ServeEngine, ServeStats)

__all__ = ["ReconfigurableGroup", "Request", "ServeEngine", "ServeStats"]
