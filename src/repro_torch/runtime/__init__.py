"""Runtime of the PyTorch port (DESIGN.md §8): verified checkpoints and
their async writer, fault tolerance (divergence sentinel, preemption,
restarts, straggler watch) and chaos injection.  The elastic rebalance
over a shrinking mesh waits for multi-GPU training (ROADMAP 'Modules to
port' item 13)."""
from .async_ckpt import AsyncCheckpointWriter
from .chaos import (
    ChaosError, ChaosEvent, ChaosMonkey, ChaosSchedule, bitflip_file,
    corrupt_newest_checkpoint, poison_nan, truncate_file,
)
from .checkpoint import (
    CheckpointCorruptError, MissingLeafError, host_snapshot, latest_step,
    latest_valid_step, list_checkpoints, prune_checkpoints,
    restore_checkpoint, save_checkpoint, verify_checkpoint,
)
from .fault import (
    DeviceDropInjector, DeviceLossError, DivergenceSentinel, FaultInjector,
    GracefulShutdown, PreemptionError, StragglerWatch, TransientSampleError,
    clear_resume_marker, read_resume_marker, run_with_restarts,
    write_resume_marker,
)

__all__ = [
    "AsyncCheckpointWriter",
    "ChaosError", "ChaosEvent", "ChaosMonkey", "ChaosSchedule",
    "bitflip_file", "corrupt_newest_checkpoint", "poison_nan",
    "truncate_file",
    "CheckpointCorruptError", "MissingLeafError", "host_snapshot",
    "latest_step", "latest_valid_step", "list_checkpoints",
    "prune_checkpoints", "restore_checkpoint", "save_checkpoint",
    "verify_checkpoint",
    "DeviceDropInjector", "DeviceLossError", "DivergenceSentinel",
    "FaultInjector", "GracefulShutdown", "PreemptionError",
    "StragglerWatch", "TransientSampleError", "clear_resume_marker",
    "read_resume_marker", "run_with_restarts", "write_resume_marker",
]
