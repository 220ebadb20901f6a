"""Expert FFN on dense capacity buffers (kernel B4)."""
