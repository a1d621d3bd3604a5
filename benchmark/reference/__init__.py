"""The plain reference (PyTorch and NumPy); imports nothing of the program."""
