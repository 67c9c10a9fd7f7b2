"""Model configurations of the port (the CHGNet family only)."""
