"""Synthetic crystal generation for the port."""
from .synthetic import SyntheticConfig, generate_crystal

__all__ = ["SyntheticConfig", "generate_crystal"]
