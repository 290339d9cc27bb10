"""Estimators and their batched (cells, time) implementations."""
