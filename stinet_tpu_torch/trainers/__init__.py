"""Training machinery of the port: optimizer, schedules, loss, steps."""
