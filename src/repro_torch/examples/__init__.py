"""Examples of the port's entry points."""
