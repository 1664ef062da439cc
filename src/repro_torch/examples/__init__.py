"""The port's counterparts of the reference's ``examples/`` scripts."""
