"""The benchmark's plain reference (float64 PyTorch, no program code)."""
