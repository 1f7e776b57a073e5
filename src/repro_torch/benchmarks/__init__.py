"""Measurement scripts of the port that live in the package (the
repository's top-level ``benchmarks/`` belongs to the reference)."""
