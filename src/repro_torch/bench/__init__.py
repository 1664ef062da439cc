"""The port's counterparts of the reference's ``benchmarks/`` scripts."""
