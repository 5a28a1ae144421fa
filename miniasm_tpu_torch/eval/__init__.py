"""Read simulation for tests and the on-card smoke run."""
