"""Model layers as plain functions on tensors."""
