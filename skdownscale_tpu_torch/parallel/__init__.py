"""The port's device layer on one device: ``mesh.pad_to_multiple``, the
zarr cell-range reader (``zarr_io.ZarrGridSource``) and the store ->
device -> store pipeline (``pipeline.run_pointwise_pipeline``)."""
