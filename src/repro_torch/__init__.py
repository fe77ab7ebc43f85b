"""PyTorch/CUDA port of the graph-partition scheduler (reference: ``repro``)."""
