"""Device-name resolution."""
