"""Copies of the reference control-plane pieces the serving path needs."""
