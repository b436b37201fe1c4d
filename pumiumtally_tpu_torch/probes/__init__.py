"""Probes of the port's kernels on their own, apart from the facade."""
