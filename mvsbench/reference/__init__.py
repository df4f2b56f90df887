"""The benchmark's plain reference: MVSNet's forward, loss and train step,
and the eval's consistency filter and fusion, in plain PyTorch, numpy and
Pillow. It imports nothing of the program it judges."""
