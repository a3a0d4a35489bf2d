"""The plain reference: PyTorch, fp32, TF32 off; it imports nothing of the program."""
