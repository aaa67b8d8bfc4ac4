"""Training core of the port (optimizer and schedules)."""
