"""Analysis of the port's dry-run records: the H100 roofline."""
