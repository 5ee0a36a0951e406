"""Runtime analysis of the port: the lock sanitizer."""
