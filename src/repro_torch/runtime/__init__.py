"""Runtime of the PyTorch port (DESIGN.md §8): verified checkpoints and
their async writer, fault tolerance (divergence sentinel, preemption,
restarts, straggler watch), chaos injection and the elastic rebalance
over a shrinking data-parallel mesh (DESIGN.md §6)."""
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
from .elastic import (
    elastic_restore, elastic_train, per_device_batch, reshard,
    surviving_mesh,
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
    "elastic_restore", "elastic_train", "per_device_batch", "reshard",
    "surviving_mesh",
    "DeviceDropInjector", "DeviceLossError", "DivergenceSentinel",
    "FaultInjector", "GracefulShutdown", "PreemptionError",
    "StragglerWatch", "TransientSampleError", "clear_resume_marker",
    "read_resume_marker", "run_with_restarts", "write_resume_marker",
]
