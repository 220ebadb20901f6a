"""B1: fused router (softmax top-k + ranks + counts + loss statistics)."""
