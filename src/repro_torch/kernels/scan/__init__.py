"""The scan kernel family: ops.py (the custom operators), ref.py (plain versions)."""
