"""The optimizer: AdamW over the parameter tree."""
