"""Process control for the port (one process; see control.py)."""
