"""Device-layer helpers of the port: so far ``mesh.pad_to_multiple``, the
one piece of ``skdownscale_tpu/parallel`` that one device needs."""
