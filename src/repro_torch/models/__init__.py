"""LM model substrate of the port: the dense decoder, forward only."""
from .api import FamilyFns, family_fns
from .config import LMConfig, MoEConfig

__all__ = ["FamilyFns", "family_fns", "LMConfig", "MoEConfig"]
