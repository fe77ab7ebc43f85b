"""Checkpoints of the training state, written asynchronously, restored onto a device."""
