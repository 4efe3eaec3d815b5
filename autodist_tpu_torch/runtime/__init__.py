"""Runtime: the Runner that owns the distributed state and executes the
lowered programs."""
