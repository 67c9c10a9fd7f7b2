"""Runtime of the PyTorch port: so far only the data pipeline's transient
sample error.  Checkpointing, restarts, elasticity and chaos injection
(the rest of ``repro.runtime``) come with ROADMAP 'Modules to port' item
12."""
from .fault import TransientSampleError

__all__ = ["TransientSampleError"]
