"""Plain float64 PyTorch references, independent of the program."""
