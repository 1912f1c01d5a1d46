"""Measurement tools for the port (each module says where it runs)."""
