"""Plain float32 PyTorch versions of what the cells' timed paths compute:
the towers (``model``), the exact top-k (``topk``) and training with a
sampled softmax (``train``). Nothing here imports the program."""
