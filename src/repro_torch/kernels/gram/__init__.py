"""The gram kernel family: ops.py (wrapper), ref.py (plain version)."""
