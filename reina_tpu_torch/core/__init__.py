"""Core engine of the port: host compile, the day step, the run loop."""
