"""B3: GQA flash-decode over a slot-batched KV cache."""
