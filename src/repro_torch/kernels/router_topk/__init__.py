"""B1: fused router (softmax top-k + ranks + counts + loss statistics);
B5: the gating-only router (weights and indices)."""
