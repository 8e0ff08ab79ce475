"""IO: synthetic scene generation, trajectory formats."""
