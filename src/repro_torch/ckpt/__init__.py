from repro_torch.ckpt.manager import CheckpointManager, latest_step

__all__ = ["CheckpointManager", "latest_step"]
