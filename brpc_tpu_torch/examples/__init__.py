"""Example programs of the port, run as modules from the repo root."""
