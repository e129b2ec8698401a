"""Measurement scripts of the port, run on a card from the repo root (see
each module); nothing here is imported by the package."""
