"""Tensor operations of the port: ordered keys, regression, rolling means."""
