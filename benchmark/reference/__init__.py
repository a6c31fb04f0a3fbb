"""The plain reference: the models and the k-means of the cells in plain
PyTorch, from the same inputs and weights as the program, importing nothing
of the program, of JAX or of ``tests/``."""
