"""The plain reference the run is held against (imports nothing of the program)."""
