"""MD serving for the port: bucketed batched inference + Verlet-skin reuse."""
from .engine import BatchedMD, ServeEngine, structure_ladder

__all__ = ["BatchedMD", "ServeEngine", "structure_ladder"]
