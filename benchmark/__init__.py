"""The benchmark of the PyTorch/CUDA port: `benchmark/run.py` runs one cell
(`benchmark/harness.py`)."""
