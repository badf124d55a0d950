from repro_torch.train.stragglers import StragglerMonitor
from repro_torch.train.trainer import Trainer, TrainState

__all__ = ["Trainer", "TrainState", "StragglerMonitor"]
