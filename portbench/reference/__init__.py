"""The plain reference the benchmark holds the program to: plain PyTorch and
NumPy, importing nothing of the program."""
