"""Token data for training: synthetic and memmap sources, prefetched."""
