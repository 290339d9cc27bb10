"""Utilities: calendars, the native host libraries, the prefetching feed,
zarr stores, checkpoints, metrics, disaggregation and profiling."""
