"""The benchmark's plain references: float32 PyTorch, independent of the
program under test."""
